"""TopologyGraph (port of ``marie_tpu/serve/runtimes/gateway/topology_graph.py``):
the deployment DAG the gateway sends each request through.

Built from ``{node: [outgoing, ...]}`` with the ``start-gateway`` and
``end-gateway`` virtual nodes: a node waits for its predecessors and
takes their docs reduced (deduped by id) when it has several; floating
nodes run but are not awaited for the answer; ``target_executor`` is a
regex over node names (a node it does not match passes the docs on
without a call); a node whose discovered endpoints lack the request's
(and ``/default``) is skipped; a node with a ``when`` condition gets only
the docs that match, and the others join its output.
"""

import asyncio
import copy
import re
from typing import Any, Dict, List, Optional, Sequence

from marie_tpu_torch.serve.networking import GrpcConnectionPool
from marie_tpu_torch.serve.runtimes.gateway.conditions import doc_matches
from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
from marie_tpu_torch.types.docs import DocumentArray
from marie_tpu_torch.types.request import DataRequest

START = "start-gateway"
END = "end-gateway"


class TopologyGraph:
    def __init__(self, graph_description: Dict[str, List[str]],
                 deployments_metadata: Optional[Dict[str, Any]] = None,
                 floating_deployments: Optional[Sequence[str]] = None,
                 node_conditions: Optional[Dict[str, Dict[str, Any]]] = None):
        self.graph = {k: list(v) for k, v in graph_description.items()}
        self.floating = set(floating_deployments or [])
        self.node_conditions = dict(node_conditions or {})
        # endpoints each node serves, discovered once (None: unknown, send)
        self._endpoints_cache: Dict[str, Optional[set]] = {}
        names = set()
        for src, dsts in self.graph.items():
            if src not in (START, END):
                names.add(src)
            names.update(d for d in dsts if d not in (START, END))
        self.nodes = sorted(names)
        self._preds: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for src, dsts in self.graph.items():
            for d in dsts:
                if d in self._preds and src != START:
                    self._preds[d].append(src)
        self._validate()

    def _validate(self) -> None:
        from marie_tpu_torch.excepts import FlowTopologyError

        # a cycle leaves nodes unvisited by Kahn's algorithm
        indeg = {n: len(self._preds[n]) for n in self.nodes}
        queue = [n for n, d in indeg.items() if d == 0]
        seen = 0
        while queue:
            n = queue.pop()
            seen += 1
            for d in self.graph.get(n, []):
                if d in indeg:
                    indeg[d] -= 1
                    if indeg[d] == 0:
                        queue.append(d)
        if seen != len(self.nodes):
            raise FlowTopologyError("flow graph contains a cycle")

    @property
    def origin_nodes(self) -> List[str]:
        return [n for n in self.graph.get(START, []) if n != END]

    def predecessors(self, node: str) -> List[str]:
        return self._preds.get(node, [])

    def successors(self, node: str) -> List[str]:
        return [d for d in self.graph.get(node, []) if d != END]

    def ends(self) -> List[str]:
        """Nodes that feed the answer (an edge to END, or no successors),
        floating nodes left out."""
        return [n for n in self.nodes
                if (END in self.graph.get(n, []) or not self.graph.get(n))
                and n not in self.floating]

    async def stream(self, request: DataRequest, connection_pool: GrpcConnectionPool,
                     timeout: Optional[float] = None) -> DataRequest:
        """Send one request through the DAG; the merged answer."""
        results: Dict[str, asyncio.Task] = {}

        async def run_node(node: str) -> DataRequest:
            preds = self.predecessors(node)
            if preds:
                pred_resps = [r for r in [await results[p] for p in preds] if r is not None]
                for r in pred_resps:
                    if r.is_error():
                        return r
                if len(pred_resps) > 1:
                    merged_docs = WorkerRequestHandler.reduce_docs(pred_resps)
                    WorkerRequestHandler.merge_routes(pred_resps)
                    req = _clone(pred_resps[0])
                    req.docs = merged_docs
                else:
                    req = pred_resps[0]
            else:
                req = _clone(request)
            if not _targets(request.target_executor, node):
                return req
            eps = await self._node_endpoints(node, connection_pool)
            if eps is not None and request.exec_endpoint not in eps and "/default" not in eps:
                return req
            condition = self.node_conditions.get(node)
            if condition:
                matched = DocumentArray([d for d in req.docs if doc_matches(d, condition)])
                bypassed = [d for d in req.docs if not doc_matches(d, condition)]
                if not matched:
                    return req  # nothing for this node
                sub = _clone(req)
                sub.docs = matched
                resp = await connection_pool.send_requests_once([sub], deployment=node,
                                                                timeout=timeout)
                if bypassed and not resp.is_error():
                    resp.docs = DocumentArray(list(resp.docs) + bypassed)
                return resp
            return await connection_pool.send_requests_once([req], deployment=node,
                                                            timeout=timeout)

        for node in self._topo_order():  # each task awaits its predecessors
            results[node] = asyncio.create_task(run_node(node))
        responses = [await results[n] for n in self.ends()]
        # floating nodes are not awaited; their failures are logged
        for n in self.nodes:
            if n in self.floating:
                results[n].add_done_callback(_log_floating_error)
        for r in responses:
            if r.is_error():
                return r
        if len(responses) > 1:
            merged = WorkerRequestHandler.reduce_docs(responses)
            WorkerRequestHandler.merge_routes(responses)
            final = responses[0]
            final.docs = merged
            return final
        return responses[0]

    async def _node_endpoints(self, node: str,
                              connection_pool: GrpcConnectionPool) -> Optional[set]:
        """The node's endpoints by discovery, once a topology; None (send
        anyway) when discovery fails."""
        if node in self._endpoints_cache:
            return self._endpoints_cache[node]
        discover = getattr(connection_pool, "send_discover_endpoint", None)
        eps: Optional[set] = None
        if discover is not None:
            try:
                eps = set((await discover(node)).get("endpoints", []))
            except Exception:  # noqa: BLE001 — discovery is best-effort
                eps = None
        self._endpoints_cache[node] = eps
        return eps

    def _topo_order(self) -> List[str]:
        order: List[str] = []
        seen = set()

        def visit(n: str) -> None:
            if n in seen:
                return
            seen.add(n)
            for p in self.predecessors(n):
                visit(p)
            order.append(n)

        for n in self.nodes:
            visit(n)
        return order


def _targets(pattern: str, node: str) -> bool:
    """Whether ``target_executor`` addresses the node: empty targets every
    node; a malformed regex is compared as it stands."""
    if not pattern:
        return True
    try:
        return re.match(pattern, node) is not None
    except re.error:
        return pattern == node


def _clone(req: DataRequest) -> DataRequest:
    """A copy with its own docs and parameters.  As the JAX clone, it is a
    new request (``wire_mode`` ``"docs_bytes"``) holding the original's
    wire content: its docs go out as JSON."""
    clone = DataRequest(copy.deepcopy(req.header))
    clone._routes = copy.deepcopy(req.routes)
    clone._data = req._data
    clone._params_wire = req._params_wire
    clone.docs = copy.deepcopy(req.docs)
    clone.parameters = copy.deepcopy(req.parameters)
    return clone


def _log_floating_error(task: asyncio.Task) -> None:
    if task.cancelled():
        return
    ex = task.exception()
    if ex is not None:
        from marie_tpu_torch.logging_core import default_logger

        default_logger.error(f"floating node failed: {ex!r}")
