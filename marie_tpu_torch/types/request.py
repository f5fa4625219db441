"""DataRequest (port of ``marie_tpu/types/request.py``) as a plain class.

The JAX request wraps its wire proto; this one holds the same header,
status, routes, documents and parameters as Python objects, with the
same properties.  Route times are ISO-8601 strings in UTC, as
:func:`ts_iso` gives them back from the JAX request's timestamps.  The
protobuf wire form (``to_bytes`` / ``from_bytes``) waits for the gRPC
slice and raises.
"""

import dataclasses
import traceback
import uuid
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from marie_tpu_torch.excepts import not_ported
from marie_tpu_torch.types.docs import DocumentArray


def ts_iso(ts: str) -> str:
    """An ISO-8601 time as the JAX request reads it back from its
    ``Timestamp``: in UTC, ``+00:00``, microseconds at most ('' when
    unset)."""
    if not ts:
        return ""
    dt = datetime.fromisoformat(ts)
    if dt.tzinfo is not None:
        dt = dt.astimezone(timezone.utc).replace(tzinfo=None)
    return dt.isoformat() + "+00:00"


@dataclasses.dataclass
class ExceptionInfo:
    name: str = ""
    args: List[str] = dataclasses.field(default_factory=list)
    stacks: List[str] = dataclasses.field(default_factory=list)
    executor: str = ""


@dataclasses.dataclass
class Status:
    """The request's status (the JAX ``StatusProto``: SUCCESS 0, ERROR 1)."""

    SUCCESS = 0
    ERROR = 1

    code: int = 0
    description: str = ""
    exception: ExceptionInfo = dataclasses.field(default_factory=ExceptionInfo)


@dataclasses.dataclass
class Header:
    request_id: str = ""
    exec_endpoint: str = ""
    target_executor: str = ""
    status: Status = dataclasses.field(default_factory=Status)


@dataclasses.dataclass
class Route:
    executor: str
    start_time: str = ""
    end_time: str = ""


class DataRequest:
    """One request: header, documents, parameters and the routes it took.
    ``nbytes`` is its size on the wire as it arrived (0 when built in
    this process)."""

    def __init__(self, header: Optional[Header] = None):
        self.header = header or Header()
        if not self.header.request_id:
            self.header.request_id = uuid.uuid4().hex
        self._docs = DocumentArray()
        self._params: Dict[str, Any] = {}
        self._routes: List[Route] = []
        self.nbytes = 0

    @property
    def request_id(self) -> str:
        return self.header.request_id

    @request_id.setter
    def request_id(self, value: str) -> None:
        self.header.request_id = value

    @property
    def exec_endpoint(self) -> str:
        return self.header.exec_endpoint or "/"

    @exec_endpoint.setter
    def exec_endpoint(self, value: str) -> None:
        self.header.exec_endpoint = value

    @property
    def target_executor(self) -> str:
        return self.header.target_executor or ""

    @target_executor.setter
    def target_executor(self, value: str) -> None:
        self.header.target_executor = value

    @property
    def docs(self) -> DocumentArray:
        return self._docs

    @docs.setter
    def docs(self, docs) -> None:
        self._docs = docs if isinstance(docs, DocumentArray) else DocumentArray(docs)

    @property
    def parameters(self) -> Dict[str, Any]:
        return self._params

    @parameters.setter
    def parameters(self, value: Dict[str, Any]) -> None:
        self._params = dict(value or {})

    @property
    def status(self) -> Status:
        return self.header.status

    def is_error(self) -> bool:
        return self.header.status.code == Status.ERROR

    def add_exception(self, ex: BaseException, executor: str = "") -> None:
        st = self.header.status
        st.code = Status.ERROR
        st.description = repr(ex)
        st.exception = ExceptionInfo(
            name=type(ex).__name__, args=[str(a) for a in ex.args],
            stacks=traceback.format_exception(type(ex), ex, ex.__traceback__),
            executor=executor)

    def add_route(self, executor: str, start_time: str = "", end_time: str = "") -> None:
        """Record a hop; times are ISO-8601 strings."""
        self._routes.append(Route(executor, ts_iso(start_time), ts_iso(end_time)))

    @property
    def routes(self) -> List[Route]:
        return self._routes

    @property
    def doc_count(self) -> int:
        return len(self._docs)

    def to_bytes(self) -> bytes:
        raise not_ported("DataRequest.to_bytes (the protobuf wire form)")

    @classmethod
    def from_bytes(cls, data: bytes) -> "DataRequest":
        raise not_ported("DataRequest.from_bytes (the protobuf wire form)")

    @classmethod
    def from_docs(cls, docs, endpoint: str = "/", parameters: Optional[Dict[str, Any]] = None,
                  target_executor: str = "") -> "DataRequest":
        req = cls()
        req.docs = docs
        req.exec_endpoint = endpoint
        if parameters:
            req.parameters = parameters
        if target_executor:
            req.target_executor = target_executor
        return req

    def __repr__(self) -> str:
        return (f"<DataRequest {self.request_id[:8]} endpoint={self.exec_endpoint} "
                f"docs={len(self.docs)}>")


Response = DataRequest  # responses reuse the same envelope
