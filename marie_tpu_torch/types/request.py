"""DataRequest (port of ``marie_tpu/types/request.py``) as a plain class
over the ``jina.DataRequestProto`` wire form of
:mod:`marie_tpu_torch.proto.messages`.

As the JAX request, it decodes lazily: the documents and parameters of a
request read from bytes are decoded when first accessed, and until then
go back out as they came.  Documents ride in ``data`` as either a
``docarray.DocListProto`` (``wire_mode`` ``"docs"``) or JSON bytes
(``"docs_bytes"``, the default); a request answers in the mode it
arrived in.  Parameters are a ``google.protobuf.Struct`` (numbers come
back as floats, as ``json_format`` gives them).  ``to_bytes`` writes the
JAX request's bytes for the same content, byte for byte: the header's
``optional`` fields (``exec_endpoint``, ``target_executor``,
``timeout``) are None when absent, and route times keep the
``Timestamp``'s seconds and nanoseconds.
"""

import calendar
import copy
import dataclasses
import json
import traceback
import uuid
from datetime import datetime, timedelta, timezone
from typing import Any, Dict, List, Optional, Sequence, Tuple

from marie_tpu_torch.proto import messages
from marie_tpu_torch.types.docs import DocumentArray

_EPOCH = datetime(1970, 1, 1)


def ts_iso(ts: str) -> str:
    """An ISO-8601 time as the JAX request reads it back from its
    ``Timestamp``: in UTC, ``+00:00``, microseconds at most ('' when
    unset)."""
    if not ts:
        return ""
    return timestamp_iso(iso_timestamp(ts))


def iso_timestamp(ts: str) -> Tuple[int, int]:
    """(seconds, nanos) of an ISO-8601 time, as ``Timestamp.FromDatetime``
    takes it (a naive time is UTC)."""
    dt = datetime.fromisoformat(ts)
    return calendar.timegm(dt.utctimetuple()), dt.microsecond * 1000


def timestamp_iso(ts: Optional[Tuple[int, int]]) -> str:
    """``ts_iso`` of the JAX package: '' at the epoch or when unset."""
    if ts is None or ts == (0, 0):
        return ""
    seconds, nanos = ts
    dt = _EPOCH + timedelta(seconds=seconds, microseconds=int(nanos / 1000))
    return dt.isoformat() + "+00:00"


@dataclasses.dataclass
class ExceptionInfo:
    name: str = ""
    args: List[str] = dataclasses.field(default_factory=list)
    stacks: List[str] = dataclasses.field(default_factory=list)
    executor: str = ""


@dataclasses.dataclass
class Status:
    """The request's status (the JAX ``StatusProto``: SUCCESS 0, ERROR 1).
    ``present`` says it was set or read from the wire, and so is written."""

    SUCCESS = 0
    ERROR = 1

    code: int = 0
    description: str = ""
    exception: Optional[ExceptionInfo] = None
    present: bool = dataclasses.field(default=False, compare=False)

    def __post_init__(self):
        if self.exception is None:
            self.exception = ExceptionInfo()
            self._exception_present = False
        else:
            self._exception_present = True

    def to_wire(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"code": self.code, "description": self.description}
        ex = self.exception
        if self._exception_present or ex != ExceptionInfo():
            out["exception"] = {"name": ex.name, "args": list(ex.args),
                                "stacks": list(ex.stacks), "executor": ex.executor}
        return out

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "Status":
        ex = d.get("exception")
        exception = None if ex is None else ExceptionInfo(
            ex.get("name", ""), list(ex.get("args", [])), list(ex.get("stacks", [])),
            ex.get("executor", ""))
        return cls(d.get("code", 0), d.get("description", ""), exception, present=True)

    def written(self) -> bool:
        return self.present or self != Status()


@dataclasses.dataclass
class Header:
    """``HeaderProto``: None marks an ``optional`` field that is absent."""

    request_id: str = ""
    exec_endpoint: Optional[str] = None
    target_executor: Optional[str] = None
    status: Status = dataclasses.field(default_factory=Status)
    timeout: Optional[int] = None

    def to_wire(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"request_id": self.request_id}
        if self.status.written():
            out["status"] = self.status.to_wire()
        for key in ("exec_endpoint", "target_executor", "timeout"):
            if getattr(self, key) is not None:
                out[key] = getattr(self, key)
        return out

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "Header":
        status = Status.from_wire(d["status"]) if "status" in d else Status()
        return cls(d.get("request_id", ""), d.get("exec_endpoint"), d.get("target_executor"),
                   status, d.get("timeout"))


def _ts_wire(ts: Optional[Tuple[int, int]]) -> Dict[str, int]:
    return {"seconds": ts[0], "nanos": ts[1]}


@dataclasses.dataclass
class Route:
    """A hop: the executor, its start and end ``Timestamp`` as (seconds,
    nanos) (None when unset) and its status when one was set."""

    executor: str
    start: Optional[Tuple[int, int]] = None
    end: Optional[Tuple[int, int]] = None
    status: Optional[Status] = None

    @property
    def start_time(self) -> str:
        return timestamp_iso(self.start)

    @property
    def end_time(self) -> str:
        return timestamp_iso(self.end)

    def to_wire(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"executor": self.executor}
        if self.start is not None:
            out["start_time"] = _ts_wire(self.start)
        if self.end is not None:
            out["end_time"] = _ts_wire(self.end)
        if self.status is not None:
            out["status"] = self.status.to_wire()
        return out

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "Route":
        def ts(key):
            t = d.get(key)
            return None if t is None else (t.get("seconds", 0), t.get("nanos", 0))

        status = d.get("status")
        return cls(d.get("executor", ""), ts("start_time"), ts("end_time"),
                   None if status is None else Status.from_wire(status))


class DataRequest:
    """One request: header, documents, parameters and the routes it took.
    ``nbytes`` is its size on the wire as it arrived (0 when built in
    this process)."""

    def __init__(self, header: Optional[Header] = None):
        self.header = header or Header()
        if not self.header.request_id:
            self.header.request_id = uuid.uuid4().hex
        self._docs: Optional[DocumentArray] = None  # decoded documents
        self._params: Optional[Dict[str, Any]] = None  # decoded parameters
        self._data: Optional[Dict[str, Any]] = None  # DataContentProto (None: absent)
        self._params_wire: Optional[Dict[str, Any]] = None  # Struct (None: absent)
        self._routes: List[Route] = []
        self.wire_mode = "docs_bytes"
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
        if self._docs is None:
            data = self._data or {}
            if data.get("docs_bytes"):
                self._docs = DocumentArray.from_json(data["docs_bytes"].decode())
            elif "docs" in data:
                self._docs = DocumentArray.from_docarray_proto(data["docs"])
            else:
                self._docs = DocumentArray()
        return self._docs

    @docs.setter
    def docs(self, docs) -> None:
        self._docs = docs if isinstance(docs, DocumentArray) else DocumentArray(docs)

    @property
    def parameters(self) -> Dict[str, Any]:
        if self._params is None:
            self._params = messages.struct_to_py(self._params_wire or {})
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
        st.present = True

    def add_route(self, executor: str, start_time: str = "", end_time: str = "") -> None:
        """Record a hop; times are ISO-8601 strings (wire: Timestamp)."""
        self._routes.append(Route(executor, iso_timestamp(start_time) if start_time else None,
                                  iso_timestamp(end_time) if end_time else None))

    @property
    def routes(self) -> List[Route]:
        return self._routes

    @property
    def doc_count(self) -> int:
        """Number of docs, without decoding a DocListProto payload."""
        if self._docs is None and "docs" in (self._data or {}):
            return len(self._data["docs"].get("docs", []))
        return len(self.docs)

    # --- the wire form ------------------------------------------------
    def flush(self) -> None:
        """Write the decoded documents and parameters back into the wire
        form (the documents in the request's ``wire_mode``)."""
        if self._docs is not None:
            if self.wire_mode == "docs":
                self._data = {"docs": self._docs.to_docarray_proto()}
            else:
                self._data = {"docs_bytes": self._docs.to_json().encode()}
        if self._params is not None:
            self._params_wire = messages.py_to_struct(_jsonable(self._params))

    def to_wire(self) -> Dict[str, Any]:
        """The ``DataRequestProto`` of this request (dict form)."""
        self.flush()
        out: Dict[str, Any] = {"header": self.header.to_wire()}
        if self._params_wire is not None:
            out["parameters"] = self._params_wire
        if self._routes:
            out["routes"] = [r.to_wire() for r in self._routes]
        if self._data is not None:
            out["data"] = self._data
        return out

    def to_bytes(self) -> bytes:
        return messages.encode("jina.DataRequestProto", self.to_wire())

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "DataRequest":
        req = cls(Header.from_wire(d.get("header", {})))
        req._params_wire = d.get("parameters")
        req._routes = [Route.from_wire(r) for r in d.get("routes", [])]
        req._data = d.get("data")
        req.wire_mode = "docs" if "docs" in (req._data or {}) else "docs_bytes"
        return req

    @classmethod
    def from_bytes(cls, data: bytes) -> "DataRequest":
        req = cls.from_wire(messages.decode("jina.DataRequestProto", data))
        req.nbytes = len(data)
        return req

    def copy(self) -> "DataRequest":
        """A request with the same wire content: header, routes and
        (undecoded) documents and parameters; nothing is shared that
        either one changes in place."""
        self.flush()
        clone = DataRequest(copy.deepcopy(self.header))
        clone._params_wire = self._params_wire
        clone._data = self._data
        clone._routes = copy.deepcopy(self._routes)
        clone.wire_mode = self.wire_mode
        return clone

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


def _jsonable(obj: Any) -> Any:
    """Parameters may carry non-JSON scalars (numpy): normalise them for
    the Struct as ``json.dumps(default=...)`` does."""
    return json.loads(json.dumps(obj, default=_json_default))


def _json_default(o: Any):
    import numpy as np

    if isinstance(o, (np.integer, np.floating)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, bytes):
        import base64

        return base64.b64encode(o).decode()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


def to_request_list_bytes(requests: Sequence[DataRequest]) -> bytes:
    """Serialize requests as ``jina.DataRequestListProto``, the wire type
    of ``JinaDataRequestRPC/process_data``."""
    return messages.encode("jina.DataRequestListProto",
                           {"requests": [r.to_wire() for r in requests]})


def from_request_list_bytes(data: bytes) -> List[DataRequest]:
    """Parse ``DataRequestListProto`` bytes -> list of :class:`DataRequest`."""
    lst = messages.decode("jina.DataRequestListProto", data)
    out = [DataRequest.from_wire(p) for p in lst.get("requests", [])]
    if out:
        out[0].nbytes = len(data)
    return out


Response = DataRequest  # responses reuse the same envelope
