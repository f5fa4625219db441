"""The port's server shell and CLI against the JAX package's.

One Flow a package (echo -> capabilities -> the OCR mock, the executors of
``tests/integration/test_server_control_plane.py``), each with its
package's ``_run_control_plane`` on a loop thread of this process.  The
same REST calls go to both: a job's lifecycle, failed jobs, cron
schedules, nodes, health, probes, metrics, the forwarders and their error
answers, the server-sent events of a job, and the Bearer check.  Status
codes, body keys, job states and bodies (ids and times masked) must be
equal.  The CLI: ``job`` commands against each package's control plane,
``export`` of a Flow YAML, ``ping``, ``help`` and ``new`` against the JAX
CLI's output; ``server --start --uses`` on a temporary YAML and ``flow
--uses`` boot the port in a child process, which stops on SIGTERM /
SIGINT.

The port's executors are defined here at module level (spawned pods import
them by name); the JAX package is imported only inside fixtures and
tests, so the port's pods stay light."""

import asyncio
import base64
import http.client
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from marie_tpu_torch.executor.text_extraction_executor import TextExtractionExecutorMock
from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors.decorators import requests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASKED = ("id", "jobid", "created_on", "started_on", "completed_on")


class PortEcho(BaseExecutor):
    @requests(on="/echo")
    def echo(self, docs, parameters, **kwargs):
        for d in docs:
            d.text = f"echo:{d.text}"
        return docs

    @requests(on="/boom")
    def boom(self, docs, **kwargs):
        raise RuntimeError("intentional failure")


class PortCapabilities(BaseExecutor):
    @requests(on="/ner/extract")
    def ner(self, docs, parameters, **kwargs):
        return {"status": "succeeded", "kind": "ner", "doc_id": parameters.get("doc_id")}

    @requests(on="/document/classify")
    def classify(self, docs, parameters, **kwargs):
        return {"status": "succeeded", "kind": "classify", "doc_type": parameters.get("doc_type")}

    @requests(on="/overlay/segment")
    def overlay(self, docs, **kwargs):
        for d in docs:
            d.tags["cleaned"] = True
        return docs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def call(port, method, path, body=None, headers=None, raw=None):
    """(status, JSON body or text) of one REST call."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, text = r.status, r.read()
    except urllib.error.HTTPError as ex:
        status, text = ex.code, ex.read()
    try:
        return status, json.loads(text)
    except ValueError:
        return status, text.decode(errors="replace")


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in MASKED else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_mask(v) for v in obj)
    return obj


class _Loop:
    """An asyncio loop on a thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def submit(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)


def _wait_health(port, timeout=30.0):
    end = time.time() + timeout
    while time.time() < end:
        try:
            if call(port, "GET", "/health/status")[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise TimeoutError(f"no control plane on {port}")


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    """{"port": rest port, "jax": rest port, "flows": (port flow, jax flow)}."""
    import marie_tpu.scheduler.sql as jsql
    import marie_tpu_torch.scheduler.sql as tsql
    from marie_tpu.executor.text_extraction_executor import TextExtractionExecutorMock as JMock
    from marie_tpu.orchestrate.flow import Flow as JFlow
    from marie_tpu_server import _run_control_plane as jax_plane
    from marie_tpu_torch.orchestrate.flow import Flow
    from marie_tpu_torch.server import _run_control_plane as port_plane
    from tests.integration.executors import CapabilitiesExecutor, EchoExecutor

    knobs = ("POLL_MIN", "POLL_MAX", "MONITOR_INTERVAL")
    old = {(mod, k): getattr(mod, k) for mod in (tsql, jsql) for k in knobs}
    for mod in (tsql, jsql):  # the scheduler polls often, so jobs start at once
        mod.POLL_MIN, mod.POLL_MAX, mod.MONITOR_INTERVAL = 0.1, 0.2, 0.5
    flows = (Flow().add(uses=PortEcho, name="echo").add(uses=PortCapabilities, name="caps")
             .add(uses=TextExtractionExecutorMock, name="extract_t"),
             JFlow().add(uses=EchoExecutor, name="echo").add(uses=CapabilitiesExecutor,
                                                            name="caps")
             .add(uses=JMock, name="extract_t"))
    loop = _Loop()
    tasks = []
    try:
        starts = [threading.Thread(target=f.start) for f in flows]  # both at once
        for t in starts:
            t.start()
        for t in starts:
            t.join()
        assert all(f.gateway_pod is not None for f in flows)
        ports = {"port": _free_port(), "jax": _free_port()}
        for side, plane, flow in (("port", port_plane, flows[0]), ("jax", jax_plane, flows[1])):
            state = tmp_path_factory.mktemp(f"state-{side}")

            async def start(plane=plane, flow=flow, port=ports[side], state=state):
                return asyncio.ensure_future(plane(flow, port, state_dir=str(state)))

            tasks.append(loop.submit(start()).result(10))
        for port in ports.values():
            _wait_health(port)
        yield {**ports, "flows": flows}
    finally:
        for t in tasks:
            loop.loop.call_soon_threadsafe(t.cancel)
        time.sleep(0.5)
        loop.close()
        for f in flows:
            f.close()
        for (mod, k), v in old.items():
            setattr(mod, k, v)


def _both(planes, fn):
    return fn(planes["port"]), fn(planes["jax"])


def _job_until_terminal(port, job_id, timeout=30.0):
    end = time.time() + timeout
    while time.time() < end:
        status, info = call(port, "GET", f"/api/jobs/{job_id}")
        if info.get("state") in ("completed", "failed", "cancelled", "expired"):
            return status, info
        time.sleep(0.1)
    raise TimeoutError(f"job {job_id} not terminal")


def test_job_lifecycle_equals_jax(planes):
    def drive(port):
        out = {}
        status, sub = call(port, "POST", "/api/jobs/submit", {"entrypoint": "/echo",
                                                              "metadata": {"m": 1}})
        out["submit"] = (status, sorted(sub), sub["status"])
        out["info"] = _mask(_job_until_terminal(port, sub["jobid"]))
        status, jobs = call(port, "GET", "/api/jobs")
        out["listed"] = status, any(j["id"] == sub["jobid"] for j in jobs["jobs"])
        out["keys"] = sorted(jobs["jobs"][0])
        out["missing"] = call(port, "GET", "/api/jobs/missing")
        out["stop"] = call(port, "POST", f"/api/jobs/{sub['jobid']}/stop")
        out["delete"] = call(port, "DELETE", f"/api/jobs/{sub['jobid']}")
        status, sub = call(port, "POST", "/api/jobs/submit", {"entrypoint": "/boom",
                                                              "retry_limit": 0, "priority": 3})
        out["failed"] = _mask(_job_until_terminal(port, sub["jobid"]))
        return out

    port, jax = _both(planes, drive)
    assert port == jax
    assert port["info"][1]["state"] == "completed" and port["failed"][1]["state"] == "failed"


def test_job_commands_of_the_cli_equal_jax(planes, capsys):
    import marie_tpu_cli
    from marie_tpu_torch import cli

    def run(main, port, *argv):
        assert main(list(argv[:2]) + ["--server", f"127.0.0.1:{port}"] + list(argv[2:])) == 0
        return json.loads(capsys.readouterr().out)

    out = []
    for main, port in ((cli.main, planes["port"]), (marie_tpu_cli.main, planes["jax"])):
        sub = run(main, port, "job", "submit", "--entrypoint", "/echo", "--metadata", '{"a": 1}')
        _job_until_terminal(port, sub["jobid"])
        info = run(main, port, "job", "info", sub["jobid"])
        listed = run(main, port, "job", "list")
        stop = run(main, port, "job", "stop", sub["jobid"])
        delete = run(main, port, "job", "delete", sub["jobid"])
        missing = run(main, port, "job", "info", "nope")
        out.append(_mask([sub, info, sorted(listed), stop, delete, missing]))
    assert out[0] == out[1]


def test_schedules_equal_jax(planes):
    def drive(port):
        out = [call(port, "POST", "/api/schedules",
                    {"queue": "cronq", "cron": "* * * * *", "data": {"entrypoint": "/echo"}}),
               call(port, "POST", "/api/schedules", {"queue": "bad", "cron": "nope"}),
               call(port, "POST", "/api/schedules", {"cron": "* * * * *"})]
        status, listed = call(port, "GET", "/api/schedules")
        out.append((status, [(s["name"], s["cron"], s["data"]) for s in listed["schedules"]]))
        fired = False
        end = time.time() + 20
        while time.time() < end and not fired:
            fired = any(j["name"] == "cronq" for j in call(port, "GET", "/api/jobs")[1]["jobs"])
            time.sleep(0.2)
        out += [fired, call(port, "DELETE", "/api/schedules/cronq"),
                call(port, "DELETE", "/api/schedules/cronq"), call(port, "GET", "/api/schedules")]
        return out

    port, jax = _both(planes, drive)
    assert port == jax
    assert port[3] == (200, [("cronq", "* * * * *", '{"entrypoint": "/echo"}')]) and port[4]


def test_nodes_probes_and_metrics_equal_jax(planes):
    def drive(port):
        status, nodes = call(port, "GET", "/api/nodes")
        out = [(status, sorted(nodes), sorted(nodes["deployments"]),
                [len(v) for v in nodes["deployments"].values()])]
        for path in ("/health/status", "/api/document/status", "/api/ner/status",
                     "/api/overlay/status"):
            out.append(call(port, "GET", path))
        status, text = call(port, "GET", "/metrics")
        out.append((status, isinstance(text, str)))
        out.append(call(port, "GET", "/api/nowhere")[0])
        out.append(call(port, "DELETE", "/api/jobs")[0])
        out.append(call(port, "PUT", "/api/schedules/x")[0])
        return out

    port, jax = _both(planes, drive)
    assert port == jax
    assert port[-3:] == [404, 405, 405]


def _png(h=32, w=32):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((h, w, 3), 255, np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_consoles_read_both_control_planes(planes):
    """``fetch_snapshot`` of either package reads either control plane
    alike (a job submitted first), and the port's poller renders the
    nodes and jobs it reads."""
    from marie_tpu_server import ctl as jctl
    from marie_tpu_torch.server import ctl, watch

    for side in ("port", "jax"):
        status, body = call(planes[side], "POST", "/api/jobs/submit",
                            {"queue": "console", "entrypoint": "/echo"})
        assert status == 200, body
    for side in ("port", "jax"):
        base = f"http://127.0.0.1:{planes[side]}"
        snaps = [ctl.fetch_snapshot(base), jctl.fetch_snapshot(base)]
        assert all(s.ok and not s.error for s in snaps), snaps
        mine, theirs = snaps
        assert (mine.gateway, mine.deployments, mine.events) == \
            (theirs.gateway, theirs.deployments, theirs.events)
        assert [j["id"] for j in mine.jobs] == [j["id"] for j in theirs.jobs]
        assert sorted(mine.deployments) == ["caps", "echo", "extract_t"]
        assert any(j["name"] == "console" for j in mine.jobs)
    nodes = watch._get(f"http://127.0.0.1:{planes['port']}", "/api/nodes")
    jobs = watch._get(f"http://127.0.0.1:{planes['port']}", "/api/jobs")
    lines = watch.render(nodes, jobs, "x:1")
    assert f"  gateway: 127.0.0.1:{planes['flows'][0].port_gateway}" in lines
    assert "  deployment echo                 1 replica(s)" in lines
    assert any("console" in ln for ln in lines) and lines[-1].startswith("    ")
    assert watch.render(None, None, "x:1")[-1] == "  server unreachable"
    down = ctl.fetch_snapshot(f"http://127.0.0.1:{_free_port()}", timeout=0.5)
    assert not down.ok and down.error


def test_forwarders_and_their_errors_equal_jax(planes):
    payload = {"data": _png()}

    def drive(port):
        out = [call(port, "POST", "/api/document/extract", payload),
               call(port, "POST", "/api/document/extract", {}),
               call(port, "POST", "/api/document/extract",
                    {"data": base64.b64encode(b"plain text").decode()}),
               call(port, "POST", "/api/ner/extract", {**payload, "doc_id": "d-77"}),
               call(port, "POST", "/api/document/classify", {**payload, "doc_type": "invoice"}),
               call(port, "POST", "/api/document/extract",
                    {"uri": "/definitely/missing.png"})]
        status, body = call(port, "POST", "/api/overlay", payload)
        out.append((status, body["status"], [d["tags"] for d in body["docs"]]))
        return out

    port, jax = _both(planes, drive)
    assert port == jax
    assert port[0][0] == 200 and port[0][1]["metadata"]["ocr"]
    assert port[1][0] == 400 and port[3][1]["kind"] == "ner" and port[6][2][0]["cleaned"] is True


def test_events_stream_equals_jax(planes):
    """``/api/events`` streams a job's Toast events as server-sent events."""
    def plane_job_events(port):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=20)
        conn.request("GET", "/api/events")
        resp = conn.getresponse()
        call(port, "POST", "/api/jobs/submit", {"entrypoint": "/echo"})
        buf, names, end = b"", [], time.time() + 20
        while len(names) < 3 and time.time() < end:
            buf += resp.read1(65536)
            while b"\n\n" in buf:
                block, buf = buf.split(b"\n\n", 1)
                fields = dict(line.split(": ", 1) for line in block.decode().splitlines())
                names.append(fields["event"])
        conn.close()
        return resp.status, resp.getheader("Content-Type").split(";")[0], names

    port, jax = _both(planes, plane_job_events)
    assert port == jax == (200, "text/event-stream", ["job.scheduled", "job.started",
                                                      "job.completed"])


def test_bearer_check_equals_jax(planes):
    from marie_tpu.auth import APIKeyManager as JKeys
    from marie_tpu_torch.auth import APIKeyManager as TKeys

    keys = [{"name": "t", "api_key": "mas_test_key", "enabled": True, "roles": ["admin"]}]
    TKeys.from_config(keys)
    JKeys.from_config(keys)
    try:
        def drive(port):
            return [call(port, "GET", "/api/jobs"),
                    call(port, "GET", "/api/jobs", headers={"Authorization": "Bearer nope"}),
                    call(port, "GET", "/api/nodes",
                         headers={"Authorization": "Bearer mas_test_key"})[0],
                    call(port, "GET", "/health/status"), call(port, "GET", "/metrics")[0],
                    call(port, "POST", "/api/document/extract", {})]

        port, jax = _both(planes, drive)
    finally:
        TKeys.clear()
        JKeys.clear()
    assert port == jax
    assert port[0] == (401, {"error": "missing or invalid API key"}) and port[2] == 200


# --- the CLI ----------------------------------------------------------------------

FLOW_YML = """jtype: Flow
with:
  port: {port}
  protocol: grpc
executors:
  - name: extract_t
    uses:
      jtype: marie_tpu.executor.TextExtractionExecutorMock
  - name: echo
    uses: tests.test_torch_server.PortEcho
"""


EXPORT_YML = """jtype: Flow
with:
  port: 52123
executors:
  - name: ocr
    uses: pkg.executors.Ocr
    replicas: 2
  - name: ner
    needs: [gateway]
    uses:
      jtype: pkg.executors.Ner
      with: {k: 1}
  - name: join
    needs: [ocr, ner]
    shards: 2
"""


def test_cli_exports_equal_jax(tmp_path, capsys):
    import yaml

    import marie_tpu_cli
    from marie_tpu_torch import cli
    from marie_tpu_torch.jaml import parser
    from tests.test_torch_jaml import _as_port

    yml = tmp_path / "flow.yml"
    yml.write_text(EXPORT_YML)
    outs = {}
    for kind in ("graph", "kubernetes", "docker-compose", "flowchart", "yaml"):
        got = []
        for main in (cli.main, marie_tpu_cli.main):
            assert main(["export", "--uses", str(yml), "--kind", kind,
                         "--namespace", "prod"]) == 0
            got.append(capsys.readouterr().out)
        outs[kind] = got
    assert json.loads(outs["graph"][0]) == json.loads(outs["graph"][1])
    k8s = [d for d in parser.load_all(outs["kubernetes"][0]) if d is not None]
    assert k8s == [d for d in yaml.safe_load_all(outs["kubernetes"][0]) if d is not None]
    assert k8s == _as_port([d for d in yaml.safe_load_all(outs["kubernetes"][1]) if d])
    assert parser.load(outs["docker-compose"][0]) == _as_port(
        yaml.safe_load(outs["docker-compose"][1]))
    assert outs["flowchart"][0] == outs["flowchart"][1]
    assert parser.load(outs["yaml"][0]) == yaml.safe_load(outs["yaml"][1]) == {"jtype": "Flow"}
    assert cli.main(["export", "--kind", "schema"]) == 0
    assert set(json.loads(capsys.readouterr().out)["definitions"]) == {
        "Marie::Flow", "Marie::Deployment", "Marie::Executor"}


def test_cli_parser_help_new_and_check(tmp_path, capsys):
    import marie_tpu_cli
    from marie_tpu.parsers import build_parser as jparser
    from marie_tpu_torch import cli
    from marie_tpu_torch.parsers import build_parser

    argvs = [["server", "--start", "--uses", "cfg.yml", "--port", "9000"],
             ["executor", "--uses", "pkg.Mod", "--name", "x"],
             ["job", "submit", "--entrypoint", "/extract"], ["job", "info", "abc"],
             ["ping", "127.0.0.1:1234"], ["dryrun", "127.0.0.1:1234"],
             ["deployment", "--uses", "pkg.Mod", "--replicas", "2", "--shards", "2"],
             ["gateway", "--deployments", '{"a": ["127.0.0.1:1"]}'], ["flow", "--uses", "f.yml"],
             ["export", "--uses", "f.yml", "--kind", "kubernetes", "--namespace", "prod"],
             ["new", "proj", "--type", "deployment"], ["help", "port"], ["completions", "zsh"],
             ["hub", "list"], ["hub", "pull", "n:1"], ["server", "--watch", "--uses", "h:1"]]
    port_only = {"device", "rest_port"}
    for argv in argvs:
        got, want = vars(build_parser().parse_args(argv)), vars(jparser().parse_args(argv))
        assert {k: v for k, v in got.items() if k not in port_only} == \
            {k: v for k, v in want.items() if k not in port_only}, argv
    args = build_parser().parse_args(["server", "--start"])
    assert (args.device, args.rest_port, args.protocol) == ("cuda", None, "grpc,http")
    with pytest.raises(SystemExit):  # a hub command is required, as in JAX
        build_parser().parse_args(["hub"])
    with pytest.raises(SystemExit):
        jparser().parse_args(["hub"])
    for argv in (["help", "port"], ["help", "nothing-like-this"]):
        codes = [cli.main(argv), None]
        mine = capsys.readouterr().out
        codes[1] = marie_tpu_cli.main(argv)
        assert (codes[0], mine) == (codes[1], capsys.readouterr().out)
    made = []
    for main, name in ((cli.main, "p"), (marie_tpu_cli.main, "j")):
        assert main(["new", str(tmp_path / name), "--type", "flow"]) == 0
        made.append(capsys.readouterr().out.splitlines()[1:])
    assert sorted(made[0]) == sorted(made[1])
    assert cli.main(["check"]) == 0
    assert "torch" in json.loads(capsys.readouterr().out)
    assert cli.main(["completions", "bash"]) == 0
    assert "complete -F _marie_complete marie" in capsys.readouterr().out
    # server --watch: the console (a plain poller off a terminal), here once
    # against a port nothing serves
    import functools

    from marie_tpu_torch.server import watch as twatch

    once = functools.partial(twatch.watch, iterations=1, interval=0)
    orig, twatch.watch = twatch.watch, once
    try:
        assert cli.main(["server", "--watch", "--uses", f"127.0.0.1:{_free_port()}"]) == 0
    finally:
        twatch.watch = orig
    out = capsys.readouterr().out
    assert "marie server watch" in out and "server unreachable" in out


def _ping_outputs(main, port, capsys):
    code = main(["ping", f"127.0.0.1:{port}"])
    return code, capsys.readouterr().out.strip()


def test_cli_server_boots_from_yaml_and_stops(planes, tmp_path, capsys):
    """``python -m marie_tpu_torch.cli server --start --uses <yml>`` boots the
    port from YAML naming the JAX executor path (mapped onto the port's),
    answers REST and job requests, ``ping`` answers as the JAX CLI does, and
    SIGTERM stops the child and its pods within 10 s."""
    import marie_tpu_cli
    from marie_tpu_torch import cli

    gateway, rest = _free_port(), _free_port()
    yml = tmp_path / "server.yml"
    yml.write_text(FLOW_YML.format(port=gateway))
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=REPO)
    child = subprocess.Popen([sys.executable, "-m", "marie_tpu_torch.cli", "server", "--start",
                              "--uses", str(yml), "--device", "cpu", "--rest-port", str(rest)],
                             cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
    try:
        _wait_health(rest, timeout=120)
        status, body = call(rest, "POST", "/api/document/extract", {"data": _png()})
        assert status == 200 and body["status"] == "succeeded" and body["metadata"]["ocr"]
        status, sub = call(rest, "POST", "/api/jobs/submit", {"entrypoint": "/echo"})
        assert _job_until_terminal(rest, sub["jobid"], timeout=60)[1]["state"] == "completed"
        nodes = call(rest, "GET", "/api/nodes")[1]
        assert sorted(nodes["deployments"]) == ["echo", "extract_t"]
        assert nodes["gateway"] == f"127.0.0.1:{gateway}"
        jax_gateway = planes["flows"][1].port_gateway
        assert _ping_outputs(cli.main, gateway, capsys) == \
            _ping_outputs(marie_tpu_cli.main, jax_gateway, capsys) == (0, "OK")
        dead = _free_port()
        got, want = _ping_outputs(cli.main, dead, capsys), _ping_outputs(marie_tpu_cli.main,
                                                                          dead, capsys)
        assert got[0] == want[0] == 1
        assert got[1].split(":")[0] == want[1].split(":")[0] == "UNREACHABLE"
        ports = [gateway, rest] + [int(a.rsplit(":", 1)[1])
                                   for v in nodes["deployments"].values() for a in v]
    finally:
        t0 = time.time()
        child.send_signal(signal.SIGTERM)
        out = child.communicate(timeout=30)[0].decode(errors="replace")
    assert child.returncode == 0, out[-3000:]
    assert time.time() - t0 < 10.0
    for port in ports:
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))


def test_cli_flow_command_serves_until_interrupted(tmp_path):
    gateway = _free_port()
    yml = tmp_path / "flow.yml"
    yml.write_text(FLOW_YML.format(port=gateway).split("  - name: echo")[0])
    env = dict(os.environ, PYTHONPATH=REPO)
    child = subprocess.Popen([sys.executable, "-m", "marie_tpu_torch.cli", "flow", "--uses",
                              str(yml)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, text=True)
    try:
        line = child.stdout.readline()
        assert line.strip() == f"flow gateway at 127.0.0.1:{gateway}"
        from marie_tpu_torch.clients import GRPCClient

        assert GRPCClient(port=gateway).dry_run(timeout=30) is True
    finally:
        child.send_signal(signal.SIGINT)
        child.communicate(timeout=30)
    assert child.returncode == 0
    assert re.fullmatch(r"flow gateway at 127\.0\.0\.1:\d+", line.strip())
