"""Flow (port of ``marie_tpu/orchestrate/flow.py``): a DAG of deployments
behind a gateway pod, from the Python API or from YAML.

``Flow().add(uses=..., name=..., needs=...)`` chains deployments (each
needs the last one added unless told otherwise; ``needs="gateway"``
starts a branch), ``needs_all()`` joins every leaf, ``build()`` checks
the graph, ``start()`` starts every deployment and then the gateway
(``protocol`` ``"grpc"`` by default, or a list: one gateway serving each,
the first on ``port``), ``close()`` stops
them; ``block()``, ``gateway_address`` and ``config_gateway`` as in the
JAX flow.  ``Flow.load_config(yml)`` (JAML: ``jtype: Flow``, ``with:`` the
constructor's keywords, ``executors:`` a list of ``add`` keywords with
``uses`` a ``jtype`` mapping, a dotted path or a class) builds it from
YAML; ``to_kubernetes_yaml`` and ``to_docker_compose_yaml`` export it
(:mod:`marie_tpu_torch.orchestrate.export`).
"""

import time
from typing import Any, Dict, List, Optional, Sequence, Type, Union

from marie_tpu_torch.excepts import FlowMissingDeploymentError, FlowTopologyError
from marie_tpu_torch.jaml import JAMLCompatible
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.orchestrate.deployments import Deployment
from marie_tpu_torch.orchestrate.pods import Pod

GATEWAY = "gateway"


def _close_all(pods: List[Pod]) -> None:
    """SIGTERM to every pod at once, then each is awaited."""
    for p in pods:
        p.terminate()
    for p in pods:
        p.close()


class Flow(JAMLCompatible):
    def __init__(self, port: Optional[int] = None,
                 protocol: Union[str, Sequence[str]] = "grpc", prefetch: int = 0,
                 name: str = "flow", **kwargs):
        self.logger = MarieLogger(f"flow/{name}")
        self.name = name
        self.port = port
        self.protocols = [protocol] if isinstance(protocol, str) else list(protocol)
        self.prefetch = prefetch
        self._deployments: Dict[str, Deployment] = {}
        self._last_added: Optional[str] = None
        self.gateway_pod: Optional[Pod] = None
        self._started = False

    def add(self, uses: Union[Type, str, dict, None] = None, name: Optional[str] = None,
            needs: Optional[Union[str, List[str]]] = None, **kwargs) -> "Flow":
        name = name or f"executor{len(self._deployments)}"
        if name in self._deployments:
            raise FlowTopologyError(f"duplicate deployment name {name!r}")
        if needs is None:
            needs = [self._last_added] if self._last_added else []
        elif isinstance(needs, str):
            needs = [needs]
        for n in needs:
            if n != GATEWAY and n not in self._deployments:
                raise FlowMissingDeploymentError(f"deployment {name!r} needs unknown {n!r}")
        self._deployments[name] = Deployment(uses=uses, name=name, needs=needs, **kwargs)
        self._last_added = name
        return self

    def needs_all(self, name: str = "joiner", **kwargs) -> "Flow":
        """Join all current leaves into one node."""
        return self.add(name=name, needs=self._leaves(), **kwargs)

    def _leaves(self) -> List[str]:
        needed = set()
        for dep in self._deployments.values():
            needed.update(dep.needs)
        return [n for n in self._deployments if n not in needed]

    def _graph_representation(self) -> Dict[str, List[str]]:
        graph: Dict[str, List[str]] = {"start-gateway": []}
        for name, dep in self._deployments.items():
            for src in dep.needs or ["start-gateway"]:
                graph.setdefault("start-gateway" if src == GATEWAY else src, []).append(name)
        for leaf in self._leaves():
            graph.setdefault(leaf, []).append("end-gateway")
        return graph

    def build(self) -> Dict[str, List[str]]:
        """The graph, checked for cycles."""
        from marie_tpu_torch.serve.runtimes.gateway.topology_graph import TopologyGraph

        graph = self._graph_representation()
        TopologyGraph(graph)
        return graph

    def start(self) -> "Flow":
        graph = self.build()
        try:
            for dep in self._deployments.values():
                dep.start()
            deps = self._deployments.values()
            self.gateway_pod = Pod(
                "gateway", graph_representation=graph,
                executor_addresses={d.name: d.addresses for d in deps},
                prefetch=self.prefetch,
                floating_deployments=[d.name for d in deps if d.floating],
                node_conditions={d.name: d.when for d in deps if d.when},
                name=f"{self.name}/gateway", protocols=self.protocols,
                ports=[self.port] + [None] * (len(self.protocols) - 1),
                port=self.port).start()
        except BaseException:
            self.close()
            raise
        self._started = True
        return self

    @property
    def port_gateway(self) -> int:
        return self.gateway_pod.port if self.gateway_pod else (self.port or 0)

    @property
    def gateway_address(self) -> str:
        return f"127.0.0.1:{self.port_gateway}"

    @property
    def pods(self) -> List[Pod]:
        """Every pod of the flow: the gateway's, then each deployment's."""
        return ([self.gateway_pod] if self.gateway_pod else []) + [
            p for d in self._deployments.values() for p in d.all_pods]

    def close(self) -> None:
        """Stop the pods front to back: the gateway, then every head, then
        every worker (each stage's pods at once), so that each hop's client
        side closes its connections first and no server port is left in
        TIME_WAIT."""
        if self.gateway_pod is not None:
            self.gateway_pod.close()
            self.gateway_pod = None
        deps = list(self._deployments.values())
        _close_all([d.head_pod for d in deps if d.head_pod is not None])
        for dep in deps:
            dep.close()
        self._started = False

    def __enter__(self) -> "Flow":
        return self.start()

    def __exit__(self, *args) -> None:
        self.close()

    def block(self) -> None:
        try:
            while self.gateway_pod is not None and self.gateway_pod.is_alive():
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass

    def config_gateway(self, prefetch: int = 0, **kwargs) -> "Flow":
        self.prefetch = prefetch
        return self

    @classmethod
    def _from_yaml_config(cls, with_kwargs: Dict[str, Any], metas=None, raw=None):
        """A Flow from its JAML mapping: ``with`` to the constructor, each
        entry of ``executors`` to :meth:`add`."""
        raw = raw or {}
        flow = cls(**with_kwargs)
        for item in raw.get("executors", []) or []:
            item = dict(item)
            uses = item.pop("uses", None)
            flow.add(uses=uses, **item)
        return flow

    def to_kubernetes_yaml(self, **kwargs) -> str:
        from marie_tpu_torch.orchestrate.export import to_kubernetes_yaml

        return to_kubernetes_yaml(self, **kwargs)

    def to_docker_compose_yaml(self, **kwargs) -> str:
        from marie_tpu_torch.orchestrate.export import to_docker_compose_yaml

        return to_docker_compose_yaml(self, **kwargs)
