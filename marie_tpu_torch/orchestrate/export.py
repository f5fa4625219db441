"""Flow export to Kubernetes, docker-compose and Mermaid (port of
``marie_tpu/orchestrate/export.py``), written with the standard-library
YAML writer (:mod:`marie_tpu_torch.jaml.parser`).

Each deployment becomes a Deployment and Service pair (or a compose
service) running the port's CLI ``executor`` command; the gateway gets the
flow's graph and addresses as environment.  Worker pods ask for one GPU
(``nvidia.com/gpu``) where the JAX export asks for a TPU.
"""

import json
from typing import Any, Dict, List, Optional

from marie_tpu_torch.jaml import parser

_DEFAULT_IMAGE = "marie-tpu-torch:latest"
_GPU_RESOURCE = "nvidia.com/gpu"
#: the command a container runs: the port's CLI
CLI_COMMAND = ["python", "-m", "marie_tpu_torch.cli"]


def _executor_args(name: str, uses: Any) -> List[str]:
    uses_ref = uses if isinstance(uses, str) else getattr(uses, "__name__", str(uses))
    if not isinstance(uses, str) and hasattr(uses, "__module__"):
        uses_ref = f"{uses.__module__}.{uses.__name__}"
    return ["executor", "--uses", uses_ref, "--name", name, "--port", "8080"]


def flow_to_kubernetes(flow, namespace: str = "marie", image: str = _DEFAULT_IMAGE,
                       gpu_resource: Optional[str] = _GPU_RESOURCE,
                       gpu_count: int = 1) -> List[Dict[str, Any]]:
    """The manifests: a Deployment and a Service for each deployment of
    the flow, then the gateway's."""
    manifests: List[Dict[str, Any]] = []
    for name, dep in flow._deployments.items():
        labels = {"app": f"marie-{name}"}
        container: Dict[str, Any] = {"name": name, "image": image,
                                     "args": _executor_args(name, dep.uses),
                                     "ports": [{"containerPort": 8080}]}
        if gpu_resource:
            container["resources"] = {"limits": {gpu_resource: gpu_count}}
        manifests.append({
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": f"marie-{name}", "namespace": namespace},
            "spec": {"replicas": dep.replicas, "selector": {"matchLabels": labels},
                     "template": {"metadata": {"labels": labels},
                                  "spec": {"containers": [container]}}}})
        manifests.append({
            "apiVersion": "v1", "kind": "Service",
            "metadata": {"name": f"marie-{name}", "namespace": namespace},
            "spec": {"selector": labels, "ports": [{"port": 8080, "targetPort": 8080}]}})
    graph = flow._graph_representation()
    addresses = {name: [f"marie-{name}.{namespace}.svc:8080"] for name in flow._deployments}
    gw_labels = {"app": "marie-gateway"}
    manifests.append({
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "marie-gateway", "namespace": namespace},
        "spec": {"replicas": 1, "selector": {"matchLabels": gw_labels},
                 "template": {"metadata": {"labels": gw_labels}, "spec": {"containers": [{
                     "name": "gateway", "image": image, "command": list(CLI_COMMAND),
                     "args": ["server", "--start"],
                     "env": [{"name": "MARIE_GRAPH", "value": json.dumps(graph)},
                             {"name": "MARIE_DEPLOYMENTS", "value": json.dumps(addresses)}],
                     "ports": [{"containerPort": 8080}]}]}}}})
    manifests.append({
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": "marie-gateway", "namespace": namespace},
        "spec": {"selector": gw_labels, "ports": [{"port": 8080, "targetPort": 8080}],
                 "type": "LoadBalancer"}})
    return manifests


def flow_to_docker_compose(flow, image: str = _DEFAULT_IMAGE) -> Dict[str, Any]:
    services: Dict[str, Any] = {}
    for name, dep in flow._deployments.items():
        services[name] = {"image": image, "entrypoint": list(CLI_COMMAND),
                          "command": _executor_args(name, dep.uses),
                          "deploy": {"replicas": dep.replicas}, "expose": [8080]}
    graph = flow._graph_representation()
    addresses = {n: [f"{n}:8080"] for n in flow._deployments}
    services["gateway"] = {
        "image": image, "entrypoint": list(CLI_COMMAND), "command": ["server", "--start"],
        "environment": {"MARIE_GRAPH": json.dumps(graph),
                        "MARIE_DEPLOYMENTS": json.dumps(addresses)},
        "ports": ["8080:8080"], "depends_on": list(flow._deployments)}
    return {"version": "3.8", "services": services}


def to_kubernetes_yaml(flow, **kwargs) -> str:
    return parser.dump_all(flow_to_kubernetes(flow, **kwargs))


def to_docker_compose_yaml(flow, **kwargs) -> str:
    return parser.dump(flow_to_docker_compose(flow, **kwargs))


def to_mermaid(flow, direction: str = "LR") -> str:
    """The flow's DAG as a Mermaid flowchart: the gateway is source and
    sink; replicas and shards annotate a node's label."""
    lines = [f"flowchart {direction}", "    gateway([gateway])"]
    graph = flow._graph_representation()
    names = {n for dsts in graph.values() for n in dsts} | set(graph)
    names -= {"start-gateway", "end-gateway"}
    for name in sorted(names):
        dep = flow._deployments.get(name)
        label = name
        if dep is not None:
            extras = []
            if getattr(dep, "replicas", 1) > 1:
                extras.append(f"x{dep.replicas}")
            if getattr(dep, "shards", 1) > 1:
                extras.append(f"{dep.shards} shards")
            if getattr(dep, "external", False):
                extras.append("external")
            if extras:
                label = f"{name}<br/>{' / '.join(extras)}"
        lines.append(f'    {name}["{label}"]')
    for src, dsts in sorted(graph.items()):
        s = "gateway" if src == "start-gateway" else src
        for dst in dsts:
            d = "gateway" if dst == "end-gateway" else dst
            lines.append(f"    {s} --> {d}")
    for leaf in flow._leaves():
        edge = f"    {leaf} --> gateway"
        if edge not in lines:
            lines.append(edge)
    return "\n".join(lines)
