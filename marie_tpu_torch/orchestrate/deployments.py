"""Deployment (port of ``marie_tpu/orchestrate/deployments.py``): an
executor served by ``replicas * shards`` worker pods over gRPC, behind a
head pod when ``shards > 1`` (``polling`` ALL, ANY or a dict of endpoint
-> mode).  The workers share the process's card; ``uses_with`` gives an
executor its device.  ``external=True`` attaches an executor already
serving at ``host:port`` that the deployment does not manage.
``stateful=True`` replicates the executor's writes through RAFT: each
worker gets a RAFT port of its own and its peers' (node ids
``<name>-<i>``), and wraps its handler (``Pod(raft=...)``).  ``env`` goes
to every worker's environment.
"""

import time
from typing import Any, Dict, List, Optional, Type, Union

from marie_tpu_torch.enums import PollingType
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.orchestrate.pods import Pod


class Deployment:
    def __init__(self, uses: Union[Type, str, dict, None] = None,
                 uses_with: Optional[Dict[str, Any]] = None, name: str = "executor",
                 replicas: int = 1, shards: int = 1, polling: Any = "all",
                 port: Optional[int] = None, protocol: str = "grpc",
                 workspace: Optional[str] = None, needs: Optional[List[str]] = None,
                 floating: bool = False, when: Optional[Dict[str, Any]] = None,
                 stateful: bool = False, env: Optional[Dict[str, str]] = None,
                 external: bool = False, host: str = "127.0.0.1", **kwargs):
        self.logger = MarieLogger(f"deployment/{name}")
        self.name = name
        self.external = external
        self.host = host
        self.uses = uses
        self.uses_with = uses_with
        self.replicas = replicas
        self.shards = shards
        self.polling = PollingType(polling.lower()) if isinstance(polling, str) else polling
        self.port = port
        self.protocol = protocol
        self.workspace = workspace
        self.needs = list(needs or [])
        self.floating = floating
        self.when = when
        self.stateful = stateful
        self.env = env or {}
        self.pods: List[Pod] = []
        self.head_pod: Optional[Pod] = None

    def start(self) -> "Deployment":
        if self.external:
            if not self.port:
                raise ValueError(f"external deployment {self.name!r} needs port=")
            return self  # nothing to spawn: addresses point at it
        self.pods = self._worker_pods()
        try:
            # every child starts at once; each is then awaited in turn
            for pod in self.pods:
                pod.launch()
            for pod in self.pods:
                pod.wait_ready()
            if self.shards > 1:
                shard_addresses = {s: [self.pods[s * self.replicas + r].address
                                       for r in range(self.replicas)]
                                   for s in range(self.shards)}
                self.head_pod = Pod(
                    "head", shard_addresses=shard_addresses,
                    # a dict carries per-endpoint polling; a mode travels as its value
                    polling=self.polling if isinstance(self.polling, dict)
                    else str(self.polling),
                    name=f"{self.name}/head", port=self.port).start()
        except BaseException:
            self.close()
            raise
        return self

    def _worker_pods(self) -> List[Pod]:
        """The worker pods (not started), with their RAFT node ids, ports
        and peers when the deployment is stateful."""
        n_workers = self.replicas * self.shards
        raft_ports = None
        if self.stateful:
            from marie_tpu_torch.helper import random_port

            raft_ports = [random_port() for _ in range(n_workers)]
        pods = []
        for i in range(n_workers):
            extra: Dict[str, Any] = {}
            if raft_ports is not None:
                extra["raft"] = {
                    "node_id": f"{self.name}-{i}",
                    "bind_addr": f"127.0.0.1:{raft_ports[i]}",
                    "peers": [(f"{self.name}-{j}", f"127.0.0.1:{raft_ports[j]}")
                              for j in range(n_workers) if j != i]}
            if self.env:
                extra["env"] = dict(self.env)
            pods.append(Pod(
                "worker", uses=self.uses, uses_with=self.uses_with,
                name=self.name if n_workers == 1 else f"{self.name}/rep-{i}",
                workspace=self.workspace, protocol="grpc",
                port=self.port if (n_workers == 1 and self.shards == 1) else None, **extra))
        return pods

    @property
    def addresses(self) -> List[str]:
        """The addresses a gateway sends to."""
        if self.external:
            return [f"{self.host}:{self.port}"]
        if self.head_pod is not None:
            return [self.head_pod.address]
        return [p.address for p in self.pods]

    @property
    def first_port(self) -> int:
        if self.head_pod is not None:
            return self.head_pod.port
        return self.pods[0].port

    @property
    def all_pods(self) -> List[Pod]:
        return self.pods + ([self.head_pod] if self.head_pod else [])

    def is_ready(self) -> bool:
        return all(p.is_alive() for p in self.all_pods)

    def close(self) -> None:
        """Stop the head, then every worker at once (a client side before
        its server's, so no server port is left in TIME_WAIT)."""
        if self.head_pod is not None:
            self.head_pod.close()
        for p in self.pods:
            p.terminate()
        for p in self.pods:
            p.close()
        self.pods = []
        self.head_pod = None

    def __enter__(self) -> "Deployment":
        return self.start()

    def __exit__(self, *args) -> None:
        self.close()

    def block(self) -> None:
        try:
            while self.is_ready():
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass
