"""``server --watch``, the live status console (port of
``marie_tpu_server/watch.py``, on the standard library: aiohttp is not on
the card's machine).

On a terminal it runs the curses TUI (:mod:`marie_tpu_torch.server.ctl`);
on a pipe, or where curses cannot start, it polls the server's REST
control plane and prints a refreshing dashboard of nodes and jobs.
"""

import asyncio
import json
import sys
import time
import urllib.request
from typing import List, Optional


def _get(base: str, path: str, timeout: float = 2.0):
    """One GET of the control plane as JSON; None when it fails."""
    try:
        with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
            return json.loads(r.read().decode())
    except Exception:  # noqa: BLE001 — an unreachable server renders as such
        return None


def render(nodes, jobs, server: str, now: Optional[float] = None) -> List[str]:
    """The poller's screen for one reading of ``/api/nodes`` and
    ``/api/jobs`` (None: unreachable)."""
    lines = ["\x1b[2J\x1b[H\x1b[1mmarie server watch\x1b[0m  "
             f"{time.strftime('%H:%M:%S', time.localtime(now))}  ({server})", ""]
    if nodes is None:
        lines.append("  server unreachable")
        return lines
    lines.append(f"  gateway: {nodes.get('gateway')}")
    for name, addrs in (nodes.get("deployments") or {}).items():
        lines.append(f"  deployment {name:<20} {len(addrs)} replica(s)")
    lines.append("")
    by_state: dict = {}
    for j in (jobs or {}).get("jobs", []):
        by_state.setdefault(j["state"], []).append(j)
    # as the JAX console: the prefix keeps the line non-empty, so "none"
    # never shows
    lines.append("  jobs: " + "  ".join(f"{state}={len(v)}"
                                         for state, v in sorted(by_state.items()))
                 or "  jobs: none")
    for j in (jobs or {}).get("jobs", [])[:10]:
        lines.append(f"    {j['id'][:8]}  {j['state']:<10} {j['name']}")
    return lines


async def watch(server: str = "127.0.0.1:8080", interval: float = 2.0,
                iterations: Optional[int] = None, out=None) -> None:
    """Poll and print every ``interval`` s (``iterations`` times, or until
    interrupted)."""
    out = out or sys.stdout
    base = f"http://{server}"
    n = 0
    while iterations is None or n < iterations:
        nodes = await asyncio.to_thread(_get, base, "/api/nodes")
        jobs = await asyncio.to_thread(_get, base, "/api/jobs")
        out.write("\n".join(render(nodes, jobs, server)) + "\n")
        out.flush()
        n += 1
        if iterations is None or n < iterations:
            await asyncio.sleep(interval)


def main(argv=None) -> int:
    server = argv[0] if argv else "127.0.0.1:8080"
    # a terminal gets the curses TUI; pipes and CI the plain poller
    if sys.stdout.isatty():
        try:
            from marie_tpu_torch.server.ctl import run_tui

            run_tui(server)
            return 0
        except Exception:  # noqa: BLE001 — no curses or terminal: the poller
            pass
    try:
        asyncio.run(watch(server))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
