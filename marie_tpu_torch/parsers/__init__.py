"""The CLI's argument parser tree (port of ``marie_tpu/parsers/__init__.py``).

The JAX tree, ``hub`` and ``server --watch`` (the live console) included.
The port adds ``server --device``
(``cuda`` by default: the kernels build on the card before the flow
starts; ``cpu`` serves without one) and ``server --rest-port`` (the
control plane's port, a free one by default).
"""

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="marie", description="marie-tpu on PyTorch/CUDA: document-AI serving")
    sub = parser.add_subparsers(dest="cli", required=True)

    server = sub.add_parser("server", help="start/control the marie server")
    server.add_argument("--start", action="store_true", help="start the server")
    server.add_argument("--uses", type=str, help="YAML config for the flow")
    server.add_argument("--port", type=int, default=None)
    server.add_argument("--protocol", type=str, default="grpc,http")
    server.add_argument("--env-file", type=str, default=None)
    server.add_argument("--watch", action="store_true", help="live status console")
    server.add_argument("--device", type=str, default="cuda",
                        help="cuda (build the kernels first) or cpu")
    server.add_argument("--rest-port", type=int, default=None,
                        help="the control plane's port (default: a free one)")

    executor = sub.add_parser("executor", help="run a single executor")
    executor.add_argument("--uses", type=str, required=True)
    executor.add_argument("--port", type=int, default=None)
    executor.add_argument("--name", type=str, default="executor")
    executor.add_argument("--protocol", type=str, default="grpc")

    flow = sub.add_parser("flow", help="run a flow from YAML")
    flow.add_argument("--uses", type=str, required=True)
    flow.add_argument("--port", type=int, default=None)

    deployment = sub.add_parser("deployment",
                                help="run a deployment (executor with replicas/shards)")
    deployment.add_argument("--uses", type=str, required=True)
    deployment.add_argument("--port", type=int, default=None)
    deployment.add_argument("--name", type=str, default="deployment")
    deployment.add_argument("--replicas", type=int, default=1)
    deployment.add_argument("--shards", type=int, default=1)
    deployment.add_argument("--polling", type=str, default="all")

    gateway = sub.add_parser("gateway", help="run a standalone gateway over executor addresses")
    gateway.add_argument("--deployments", type=str, required=True,
                         help='JSON {"name": ["host:port", ...], ...}')
    gateway.add_argument("--graph", type=str, default=None,
                         help="JSON DAG {src: [dst,...]}; default chains all deployments")
    gateway.add_argument("--port", type=int, default=None)
    gateway.add_argument("--protocol", type=str, default="grpc")

    ping = sub.add_parser("ping", help="health-check a runtime")
    ping.add_argument("host", type=str, help="host:port")

    dryrun = sub.add_parser("dryrun", help="flow readiness probe")
    dryrun.add_argument("host", type=str, help="gateway host:port")

    client = sub.add_parser("client", help="send a request")
    client.add_argument("host", type=str, help="host:port")
    client.add_argument("--endpoint", type=str, default="/")
    client.add_argument("--protocol", type=str, default="grpc")
    client.add_argument("--data", type=str, default="{}", help="JSON doc list or text")

    job = sub.add_parser("job", help="job queue operations")
    job_sub = job.add_subparsers(dest="job_cmd", required=True)
    for name in ("submit", "list", "info", "stop", "delete"):
        p = job_sub.add_parser(name)
        p.add_argument("--server", type=str, default="127.0.0.1:8080")
        if name == "submit":
            p.add_argument("--entrypoint", type=str, required=True)
            p.add_argument("--metadata", type=str, default="{}")
        elif name != "list":
            p.add_argument("job_id", type=str)

    new = sub.add_parser("new", help="scaffold a new marie project")
    new.add_argument("name", type=str, help="project directory to create")
    new.add_argument("--type", type=str, default="flow", choices=["flow", "deployment"])

    hub = sub.add_parser("hub", help="executor hub operations")
    hub_sub = hub.add_subparsers(dest="hub_cmd", required=True)
    hp = hub_sub.add_parser("push", help="publish an executor bundle")
    hp.add_argument("path", type=str, help="executor directory (with config.yml)")
    hp.add_argument("--name", type=str, default=None)
    hp.add_argument("--version", type=str, default="0.1.0")
    for name in ("pull", "versions", "manifest"):
        p = hub_sub.add_parser(name)
        p.add_argument("ref", type=str, help="executor ref (name[:version])")
    hub_sub.add_parser("list", help="list local hub bundles")

    comp = sub.add_parser("completions", help="emit a shell completion script")
    comp.add_argument("shell", type=str, choices=["bash", "zsh"])

    hlp = sub.add_parser("help", help="look up a CLI argument across commands")
    hlp.add_argument("query", type=str, help="argument name, e.g. 'port'")

    sub.add_parser("check", help="environment + device diagnostics")
    export = sub.add_parser("export", help="export flow configs")
    export.add_argument("--uses", type=str, default=None)
    export.add_argument("--kind", type=str, default="graph",
                        choices=["graph", "yaml", "kubernetes", "docker-compose", "schema",
                                 "flowchart"])
    export.add_argument("--namespace", type=str, default="marie")
    return parser
