"""The ``marie`` console entry point of the port (counterpart of
``marie_tpu_cli/__init__.py``): ``python -m marie_tpu_torch.cli <command>``.

Commands: ``server`` (``--start --uses <yml>`` boots the port through
:func:`marie_tpu_torch.server.run_server`, on the card unless ``--device
cpu``), ``executor``, ``flow``, ``deployment``, ``gateway``, ``ping``,
``dryrun``, ``client``, ``job`` (the control plane's REST API through
``urllib``), ``hub`` (push, pull, versions, manifest, list over
:class:`~marie_tpu_torch.hub.ExecutorHub`; a ``docker://`` name or
reference goes to the OCI registry at ``MARIE_REGISTRY``), ``check``,
``export``, ``new``, ``help``, ``completions``.  ``server --watch [--uses
host:port]`` opens the live console: the curses TUI on a terminal, else a
plain poller (:mod:`marie_tpu_torch.server.watch`).
"""

import json
import sys


def main(argv=None) -> int:
    from marie_tpu_torch.parsers import build_parser

    parser = build_parser()
    args = parser.parse_args(argv)
    commands = {
        "server": _server, "executor": _executor, "flow": _flow, "deployment": _deployment,
        "gateway": _gateway, "ping": _ping, "dryrun": _ping, "client": _client, "job": _job,
        "check": _check, "export": _export, "new": _new, "hub": _hub,
    }
    if args.cli in commands:
        return commands[args.cli](args)
    if args.cli == "help":
        return _help_lookup(args, parser)
    if args.cli == "completions":
        return _completions(args, parser)
    parser.print_help()
    return 1


def _cli_tree(parser):
    """{command: [options...]} for every (possibly nested) subcommand."""
    import argparse

    tree = {}
    for action in parser._subparsers._group_actions:
        if not isinstance(action, argparse._SubParsersAction):
            continue
        stack = list(action.choices.items())
        while stack:
            name, sp = stack.pop()
            opts = []
            for a in sp._actions:
                if isinstance(a, argparse._SubParsersAction):
                    stack.extend((f"{name} {n}", s) for n, s in a.choices.items())
                    opts.extend(a.choices)
                    continue
                opts.extend(a.option_strings)
            tree[name] = sorted(set(opts))
    return tree


def _completions(args, parser) -> int:
    """A bash or zsh completion script made from the parser tree."""
    tree = _cli_tree(parser)
    top = sorted(k for k in tree if " " not in k)
    if args.shell == "bash":
        cases = "\n".join(f'    {name.split()[-1]}) opts="{" ".join(opts)}" ;;'
                          for name, opts in sorted(tree.items()) if " " not in name)
        print(f"""# bash completion for marie — source this file
_marie_complete() {{
  local cur prev opts
  cur="${{COMP_WORDS[COMP_CWORD]}}"
  if [[ $COMP_CWORD -eq 1 ]]; then
    COMPREPLY=( $(compgen -W "{" ".join(top)}" -- "$cur") )
    return 0
  fi
  case "${{COMP_WORDS[1]}}" in
{cases}
    *) opts="" ;;
  esac
  COMPREPLY=( $(compgen -W "$opts" -- "$cur") )
}}
complete -F _marie_complete marie""")
    else:
        cases = "\n".join(f'    {name}) _values "options" {" ".join(opts) or "-h"} ;;'
                          for name, opts in sorted(tree.items()) if " " not in name)
        print(f"""#compdef marie
_marie() {{
  if (( CURRENT == 2 )); then
    _values "command" {" ".join(top)}
    return
  fi
  case "$words[2]" in
{cases}
  esac
}}
_marie "$@" """)
    return 0


def _help_lookup(args, parser) -> int:
    """Where an argument appears across the commands, with its help."""
    import argparse

    query = args.query.lower().lstrip("-")
    hits = []
    for action in parser._subparsers._group_actions:
        if not isinstance(action, argparse._SubParsersAction):
            continue
        for name, sp in action.choices.items():
            stack = [(name, sp)]
            while stack:
                cmd_name, p = stack.pop()
                for a in p._actions:
                    if isinstance(a, argparse._SubParsersAction):
                        stack.extend((f"{cmd_name} {n}", s) for n, s in a.choices.items())
                        continue
                    names = [o.lstrip("-") for o in a.option_strings] or [a.dest]
                    if any(query == n.lower() for n in names):
                        hits.append((cmd_name, ", ".join(a.option_strings) or a.dest,
                                     a.help or ""))
    if not hits:
        print(f"no argument matching {args.query!r} found")
        return 1
    for cmd_name, flag, help_text in hits:
        print(f"marie {cmd_name}  {flag}")
        if help_text:
            print(f"    {help_text}")
    return 0


def _new(args) -> int:
    """A project from the bundled template."""
    import os
    import shutil

    import marie_tpu_torch

    template_root = os.path.join(os.path.dirname(marie_tpu_torch.__file__), "resources",
                                 "project-template", args.type)
    target = os.path.abspath(args.name)
    if os.path.exists(target):
        print(f"error: {target} already exists")
        return 1
    shutil.copytree(template_root, target, ignore=shutil.ignore_patterns("__pycache__"))
    print(f"created {args.type} project at {target}")
    for base, _, files in os.walk(target):
        for f in sorted(files):
            print("  ", os.path.relpath(os.path.join(base, f), target))
    return 0


def _hub(args) -> int:
    """Executor hub operations over the local or remote bundle store; a
    ``docker://`` name goes to an OCI registry (``MARIE_REGISTRY``,
    ``MARIE_REGISTRY_USER``, ``MARIE_REGISTRY_PASSWORD``)."""
    import os

    from marie_tpu_torch.hub import ExecutorHub
    from marie_tpu_torch.hub import parse_hub_ref as _parse

    def parse_hub_ref(ref: str):
        # the CLI takes a bare name[:version]; the library hub://name[:version]
        return _parse(ref if ref.startswith("hub://") else f"hub://{ref}")

    def registry_client():
        from marie_tpu_torch.hub_docker import RegistryClient

        url = os.environ.get("MARIE_REGISTRY")
        if not url:
            raise SystemExit("docker:// hub refs need MARIE_REGISTRY (registry URL)")
        return RegistryClient(url, username=os.environ.get("MARIE_REGISTRY_USER"),
                              password=os.environ.get("MARIE_REGISTRY_PASSWORD"))

    hub = ExecutorHub()
    cmd = args.hub_cmd
    if cmd == "push":
        name = args.name or os.path.basename(os.path.abspath(args.path))
        if name.startswith("docker://"):
            from marie_tpu_torch.hub_docker import push_executor_image

            digest, _ = push_executor_image(registry_client(), args.path,
                                            name[len("docker://"):], tag=args.version)
            print(f"pushed {name}:{args.version} {digest}")
            return 0
        bundle = hub.push(args.path, name=name, version=args.version)
        print(f"pushed {name}:{args.version} -> {bundle}")
        return 0
    if cmd == "pull":
        if args.ref.startswith("docker://"):
            from marie_tpu_torch.hub_docker import pull_executor_image

            image, _, tag = args.ref[len("docker://"):].partition(":")
            dest = os.path.join(os.path.expanduser("~/.marie/hub-images"),
                                image.replace("/", "__"), tag or "latest")
            pull_executor_image(registry_client(), image, tag or "latest", dest)
            print(dest)
            return 0
        name, version = parse_hub_ref(args.ref)
        print(hub.pull(name, version))
        return 0
    if cmd == "versions":
        name, _ = parse_hub_ref(args.ref)
        for v in hub.versions(name):
            print(v)
        return 0
    if cmd == "manifest":
        name, version = parse_hub_ref(args.ref)
        print(json.dumps(hub.manifest(name, version), indent=1, sort_keys=True))
        return 0
    if cmd == "list":
        for entry in hub.list():
            line = f"{entry['name']}:{entry['version']}"
            if "sha256" in entry:
                line += f"  sha256:{entry['sha256'][:12]}"
            print(line)
        return 0
    return 1


def _server(args) -> int:
    if args.watch:
        from marie_tpu_torch.server.watch import main as watch_main

        return watch_main([args.uses] if args.uses else None)
    from marie_tpu_torch.server import run_server

    return run_server(uses=args.uses, port=args.port,
                      protocols=[p.strip() for p in args.protocol.split(",")],
                      env_file=args.env_file, device=args.device, rest_port=args.rest_port)


def _executor(args) -> int:
    from marie_tpu_torch.orchestrate.deployments import Deployment

    with Deployment(uses=args.uses, name=args.name, port=args.port,
                    protocol=args.protocol) as dep:
        print(f"executor {args.name} serving at {dep.addresses[0]}", flush=True)
        dep.block()
    return 0


def _flow(args) -> int:
    from marie_tpu_torch.orchestrate.flow import Flow

    flow = Flow.load_config(args.uses)
    if args.port:
        flow.port = args.port
    with flow:
        print(f"flow gateway at {flow.gateway_address}", flush=True)
        flow.block()
    return 0


def _deployment(args) -> int:
    from marie_tpu_torch.orchestrate.deployments import Deployment

    with Deployment(uses=args.uses, name=args.name, port=args.port, replicas=args.replicas,
                    shards=args.shards, polling=args.polling) as dep:
        print(f"deployment {args.name} ({args.replicas}x{args.shards}) "
              f"serving at {dep.addresses[0]}", flush=True)
        dep.block()
    return 0


def _gateway(args) -> int:
    import time

    from marie_tpu_torch.orchestrate.pods import Pod

    deployments = json.loads(args.deployments)
    if args.graph:
        graph = json.loads(args.graph)
    else:
        names = list(deployments)
        graph = {"start-gateway": names[:1]}
        for a, b in zip(names, names[1:]):
            graph[a] = [b]
        if names:
            graph[names[-1]] = ["end-gateway"]
    pod = Pod("gateway", graph_representation=graph, executor_addresses=deployments,
              port=args.port, protocol=args.protocol, name="gateway").start()
    print(f"gateway serving at {pod.address}", flush=True)
    try:
        while pod.is_alive():
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        pod.close()
    return 0


def _ping(args) -> int:
    from marie_tpu_torch.clients import Client

    host, _, port = args.host.partition(":")
    try:
        ok = Client(host=host or "127.0.0.1", port=int(port)).dry_run()
        print("OK" if ok else "DEGRADED")
        return 0 if ok else 1
    except Exception as ex:  # noqa: BLE001
        print(f"UNREACHABLE: {ex!r}")
        return 1


def _client(args) -> int:
    from marie_tpu_torch.clients import Client
    from marie_tpu_torch.types.docs import Document, DocumentArray

    host, _, port = args.host.partition(":")
    raw = args.data
    try:
        data = json.loads(raw)
        docs = DocumentArray.from_dict(data if isinstance(data, list) else [data])
    except json.JSONDecodeError:
        docs = DocumentArray([Document(text=raw)])
    client = Client(host=host or "127.0.0.1", port=int(port), protocol=args.protocol)
    result = client.post(args.endpoint, docs)
    print(json.dumps(result.to_dict(), indent=2, default=str))
    return 0


def _rest(server: str, method: str, path: str, payload=None):
    """A JSON call to the control plane; the JSON answer, error or not."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://{server}{path}", data=data, method=method.upper(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as ex:
        return json.loads(ex.read())


def _job(args) -> int:
    cmd = args.job_cmd
    if cmd == "submit":
        out = _rest(args.server, "post", "/api/jobs/submit",
                    {"entrypoint": args.entrypoint, "metadata": json.loads(args.metadata)})
    elif cmd == "list":
        out = _rest(args.server, "get", "/api/jobs")
    elif cmd == "info":
        out = _rest(args.server, "get", f"/api/jobs/{args.job_id}")
    elif cmd == "stop":
        out = _rest(args.server, "post", f"/api/jobs/{args.job_id}/stop")
    else:  # delete
        out = _rest(args.server, "delete", f"/api/jobs/{args.job_id}")
    print(json.dumps(out, indent=2))
    return 0


def _check(args) -> int:
    from marie_tpu_torch.helper import get_full_version

    print(json.dumps(get_full_version(), indent=2))
    return 0


def _export(args) -> int:
    if args.kind == "schema":
        from marie_tpu_torch.schemas import get_full_schema

        print(json.dumps(get_full_schema(), indent=2))
        return 0
    from marie_tpu_torch.orchestrate.flow import Flow

    flow = Flow.load_config(args.uses)
    if args.kind == "graph":
        print(json.dumps(flow.build(), indent=2))
    elif args.kind == "kubernetes":
        from marie_tpu_torch.orchestrate.export import to_kubernetes_yaml

        print(to_kubernetes_yaml(flow, namespace=args.namespace))
    elif args.kind == "docker-compose":
        from marie_tpu_torch.orchestrate.export import to_docker_compose_yaml

        print(to_docker_compose_yaml(flow))
    elif args.kind == "flowchart":
        from marie_tpu_torch.orchestrate.export import to_mermaid

        print(to_mermaid(flow))
    else:
        from marie_tpu_torch.jaml import JAML

        print(JAML.dump(JAML.deconstruct(flow)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
