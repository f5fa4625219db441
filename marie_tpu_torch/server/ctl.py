"""The interactive terminal console of ``server --watch`` (port of
``marie_tpu_server/ctl.py``): a curses TUI with a live nodes / jobs /
events dashboard, arrow-key job selection, an Enter-to-open scrollable
result viewer and a help overlay.

Layers, so that the TUI is testable without a terminal: the data layer
(:func:`fetch_snapshot`) polls the control plane's REST API on
``urllib``; the render layer (:func:`render_dashboard`,
:func:`render_result`, :func:`render_help`) is pure ``state ->
list[str]``; only :func:`run_tui` touches curses.
"""

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

KEYBINDINGS = [
    ("q", "quit"),
    ("r", "refresh now"),
    ("j / ↓", "next job"),
    ("k / ↑", "previous job"),
    ("enter", "open result viewer"),
    ("esc", "back to dashboard"),
    ("g / G", "scroll top / bottom (viewer)"),
    ("?", "toggle help"),
]


@dataclass
class Snapshot:
    ok: bool = False
    gateway: Optional[str] = None
    deployments: Dict[str, Any] = field(default_factory=dict)
    jobs: List[Dict[str, Any]] = field(default_factory=list)
    events: List[Dict[str, Any]] = field(default_factory=list)
    fetched_at: float = 0.0
    error: str = ""


def fetch_snapshot(base: str, timeout: float = 2.0) -> Snapshot:
    """One poll of the REST control plane (sync — the TUI polls from a
    background thread)."""
    import urllib.request

    def get(path):
        req = urllib.request.Request(f"{base}{path}")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode())

    snap = Snapshot(fetched_at=time.time())
    try:
        nodes = get("/api/nodes")
        snap.gateway = nodes.get("gateway")
        snap.deployments = nodes.get("deployments") or {}
        jobs = get("/api/jobs")
        snap.jobs = jobs if isinstance(jobs, list) else jobs.get("jobs", [])
        try:
            ev = get("/api/events/recent")
            snap.events = ev if isinstance(ev, list) else ev.get("events", [])
        except Exception:  # noqa: BLE001 — events endpoint is optional
            snap.events = []
        snap.ok = True
    except Exception as ex:  # noqa: BLE001
        snap.error = repr(ex)
    return snap


def _pad(line: str, w: int) -> str:
    return line[:w].ljust(w)


def render_dashboard(
    snap: Snapshot, w: int, h: int, selected: int, server: str
) -> List[str]:
    """Dashboard screen: header, nodes panel, jobs table, events."""
    lines = [
        _pad(
            f" marie watch  {server}  "
            f"{time.strftime('%H:%M:%S', time.localtime(snap.fetched_at))}"
            f"  [? help  q quit]",
            w,
        ),
        _pad("─" * w, w),
    ]
    if not snap.ok:
        lines.append(_pad(f" server unreachable: {snap.error}", w))
        while len(lines) < h:
            lines.append(_pad("", w))
        return lines[:h]

    lines.append(_pad(f" gateway   {snap.gateway}", w))
    for name, addrs in sorted(snap.deployments.items()):
        n = len(addrs) if isinstance(addrs, (list, tuple)) else addrs
        lines.append(_pad(f" deploy    {name:<24} replicas={n}", w))
    lines.append(_pad("", w))

    job_rows = max(4, h - len(lines) - 6)
    lines.append(
        _pad(f" {'JOB':<34}{'QUEUE':<16}{'STATE':<12}{'CREATED':<20}", w)
    )
    start = max(0, selected - job_rows + 1)
    for i, job in enumerate(snap.jobs[start : start + job_rows], start=start):
        created = job.get("created_on") or job.get("createdOn") or 0
        created_s = (
            time.strftime("%m-%d %H:%M:%S", time.localtime(created))
            if created
            else "-"
        )
        marker = ">" if i == selected else " "
        lines.append(
            _pad(
                f"{marker}{str(job.get('id', '?'))[:32]:<34}"
                f"{str(job.get('name', ''))[:14]:<16}"
                f"{str(job.get('state', ''))[:10]:<12}{created_s:<20}",
                w,
            )
        )
    if not snap.jobs:
        lines.append(_pad("  (no jobs)", w))
    lines.append(_pad("", w))

    lines.append(_pad(" recent events", w))
    for ev in snap.events[-max(0, h - len(lines) - 1):]:
        lines.append(
            _pad(f"  {ev.get('event', ev.get('type', '?'))}: "
                 f"{str(ev.get('jobid', ev.get('job_id', '')))[:24]}", w)
        )
    while len(lines) < h:
        lines.append(_pad("", w))
    return lines[:h]


def render_result(job: Dict[str, Any], w: int, h: int, scroll: int) -> List[str]:
    """Result viewer: the job record (incl. persisted output) as
    pretty JSON, scrolled."""
    body = json.dumps(job, indent=2, default=str).splitlines()
    header = [
        _pad(f" job {job.get('id', '?')}  [esc back  g/G top/bottom]", w),
        _pad("─" * w, w),
    ]
    view = body[scroll : scroll + (h - len(header))]
    lines = header + [_pad(ln, w) for ln in view]
    while len(lines) < h:
        lines.append(_pad("", w))
    return lines[:h]


def render_help(w: int, h: int) -> List[str]:
    lines = [_pad(" key bindings", w), _pad("─" * w, w)]
    for key, desc in KEYBINDINGS:
        lines.append(_pad(f"  {key:<10} {desc}", w))
    while len(lines) < h:
        lines.append(_pad("", w))
    return lines[:h]


def run_tui(server: str = "127.0.0.1:8080", interval: float = 2.0) -> None:
    """Curses main loop (requires a tty)."""
    import curses

    base = f"http://{server}"
    state = {"snap": Snapshot(), "stop": False}

    def poller():
        while not state["stop"]:
            state["snap"] = fetch_snapshot(base)
            time.sleep(interval)

    t = threading.Thread(target=poller, daemon=True)
    t.start()

    def main(stdscr):
        curses.curs_set(0)
        stdscr.nodelay(True)
        screen = "dash"  # dash | result | help
        selected = 0
        scroll = 0
        while True:
            h, w = stdscr.getmaxyx()
            snap = state["snap"]
            if screen == "dash":
                lines = render_dashboard(snap, w - 1, h, selected, server)
            elif screen == "help":
                lines = render_help(w - 1, h)
            else:
                job = snap.jobs[selected] if selected < len(snap.jobs) else {}
                lines = render_result(job, w - 1, h, scroll)
            for y, line in enumerate(lines[:h]):
                try:
                    stdscr.addstr(y, 0, line)
                except curses.error:
                    pass
            stdscr.refresh()
            ch = stdscr.getch()
            if ch == -1:
                time.sleep(0.1)
                continue
            if ch in (ord("q"),):
                break
            if ch == ord("r"):
                state["snap"] = fetch_snapshot(base)
            elif ch == ord("?"):
                screen = "help" if screen != "help" else "dash"
            elif ch in (27,):  # esc
                screen = "dash"
                scroll = 0
            elif ch in (ord("j"), curses.KEY_DOWN):
                if screen == "dash":
                    selected = min(selected + 1, max(len(snap.jobs) - 1, 0))
                else:
                    scroll += 1
            elif ch in (ord("k"), curses.KEY_UP):
                if screen == "dash":
                    selected = max(selected - 1, 0)
                else:
                    scroll = max(scroll - 1, 0)
            elif ch == ord("g"):
                scroll = 0
            elif ch == ord("G"):
                scroll = 10**6  # clamped by render slice
            elif ch in (curses.KEY_ENTER, 10, 13) and snap.jobs:
                screen = "result"
                scroll = 0

    try:
        curses.wrapper(main)
    finally:
        state["stop"] = True
