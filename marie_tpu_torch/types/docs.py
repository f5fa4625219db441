"""Document / DocumentArray (port of ``marie_tpu/types/docs.py``) on
dataclasses instead of pydantic.

The JSON is the JAX package's, byte for byte: ``to_dict`` gives the
fields in declaration order (a field a subclass declares again keeps its
place), numpy arrays as ``{"__ndarray__": base64, "dtype", "shape"}``,
bytes as ``{"__bytes__": base64}``, numpy scalars as Python numbers and
nested documents as dicts; ``id`` defaults to ``uuid4().hex``.  As
pydantic validates them, ``tensor`` / ``embedding`` become numpy arrays,
``scores`` values floats and nested ``chunks`` / ``matches`` dicts
documents, and ``from_dict`` ignores keys that are not fields.

Tensors are numpy arrays end to end; a torch tensor set on a document is
copied to the host.  The docarray protobuf forms
(``to_docarray_proto`` / ``from_docarray_proto``) are the dict form of
:mod:`marie_tpu_torch.proto.messages`, converted as the JAX package
converts them (:mod:`marie_tpu_torch.types.docarray_compat`).
"""

import base64
import dataclasses
import json
import uuid
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np



def _to_numpy(v: Any) -> Optional[np.ndarray]:
    if v is None or isinstance(v, np.ndarray):
        return v
    if hasattr(v, "detach"):  # torch.Tensor, on any device
        return v.detach().cpu().numpy()
    return np.asarray(v)


_NDARRAY_KEY = "__ndarray__"


def _encode_ndarrays(obj: Any) -> Any:
    if isinstance(obj, BaseDoc):
        return obj.to_dict()
    if isinstance(obj, np.ndarray):
        return {
            _NDARRAY_KEY: base64.b64encode(np.ascontiguousarray(obj).tobytes()).decode(),
            "dtype": str(obj.dtype),
            "shape": list(obj.shape),
        }
    if isinstance(obj, bytes):
        return {"__bytes__": base64.b64encode(obj).decode()}
    if isinstance(obj, dict):
        return {k: _encode_ndarrays(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode_ndarrays(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _decode_ndarrays(obj: Any) -> Any:
    if isinstance(obj, dict):
        if _NDARRAY_KEY in obj:
            buf = base64.b64decode(obj[_NDARRAY_KEY])
            return np.frombuffer(buf, dtype=np.dtype(obj["dtype"])).reshape(
                obj["shape"]).copy()
        if "__bytes__" in obj:
            return base64.b64decode(obj["__bytes__"])
        return {k: _decode_ndarrays(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode_ndarrays(v) for v in obj]
    return obj


class BaseDoc:
    """Base document with an auto-generated id.  Every subclass is a
    keyword-only dataclass; :meth:`_coerce` plays pydantic's validators."""

    id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, kw_only=True, eq=False, repr=False)

    def __post_init__(self):
        self._coerce()

    def _coerce(self) -> None:
        """Field conversions on construction (none on the base)."""

    @classmethod
    def _field_names(cls) -> List[str]:
        return [f.name for f in dataclasses.fields(cls)]

    def to_dict(self) -> Dict[str, Any]:
        return _encode_ndarrays({name: getattr(self, name) for name in self._field_names()})

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BaseDoc":
        known = set(cls._field_names())
        return cls(**{k: v for k, v in _decode_ndarrays(d).items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "BaseDoc":
        return cls.from_dict(json.loads(s))


dataclasses.dataclass(BaseDoc, kw_only=True, eq=False, repr=False)


def _docs(items) -> List["Document"]:
    return [Document.from_dict(d) if isinstance(d, dict) else d for d in items]


class Document(BaseDoc):
    """General-purpose document (docarray ``Document`` equivalent)."""

    text: Optional[str] = None
    uri: Optional[str] = None
    tensor: Optional[np.ndarray] = None
    blob: Optional[bytes] = None
    embedding: Optional[np.ndarray] = None
    tags: Dict[str, Any] = dataclasses.field(default_factory=dict)
    mime_type: Optional[str] = None
    modality: Optional[str] = None
    chunks: List["Document"] = dataclasses.field(default_factory=list)
    matches: List["Document"] = dataclasses.field(default_factory=list)
    scores: Dict[str, float] = dataclasses.field(default_factory=dict)
    parent_id: Optional[str] = None
    # fields of foreign doc schemas, kept for a lossless docarray round trip
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def _coerce(self) -> None:
        self.tensor = _to_numpy(self.tensor)
        self.embedding = _to_numpy(self.embedding)
        self.tags = dict(self.tags)
        self.chunks = _docs(self.chunks)
        self.matches = _docs(self.matches)
        self.scores = {k: float(v) for k, v in self.scores.items()}
        self.extra = dict(self.extra)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Document):
            return NotImplemented
        return self.id == other.id

    def __hash__(self) -> int:
        return hash(self.id)

    def __repr__(self) -> str:
        bits = [f"id={self.id[:8]}"]
        if self.text is not None:
            bits.append(f"text={self.text[:24]!r}")
        if self.tensor is not None:
            bits.append(f"tensor{self.tensor.shape}")
        if self.tags:
            bits.append(f"tags[{len(self.tags)}]")
        return f"<Document {' '.join(bits)}>"

    def to_docarray_proto(self) -> Dict[str, Any]:
        """-> a ``docarray.DocProto`` (dict form): the set fields, tags,
        scores, nested chunks and matches, then the foreign fields."""
        from marie_tpu_torch.types.docarray_compat import dict_to_docproto

        d: Dict[str, Any] = {"id": self.id}
        for name in ("text", "uri", "mime_type", "modality", "parent_id", "blob",
                     "tensor", "embedding"):
            v = getattr(self, name)
            if v is not None:
                d[name] = v
        if self.tags:
            d["tags"] = self.tags
        if self.scores:
            d["scores"] = self.scores
        if self.chunks:
            d["chunks"] = [c.to_docarray_proto_dict() for c in self.chunks]
        if self.matches:
            d["matches"] = [m.to_docarray_proto_dict() for m in self.matches]
        d.update(self.extra)
        return dict_to_docproto(d)

    def to_docarray_proto_dict(self) -> Dict[str, Any]:
        """Nested-doc form: the plain dict an enclosing DocProto embeds."""
        from marie_tpu_torch.types.docarray_compat import docproto_to_dict

        return docproto_to_dict(self.to_docarray_proto())

    @classmethod
    def from_docarray_proto(cls, dp: Dict[str, Any]) -> "Document":
        from marie_tpu_torch.types.docarray_compat import docproto_to_dict

        return cls.from_docarray_dict(docproto_to_dict(dp))

    @classmethod
    def from_docarray_dict(cls, d: Dict[str, Any]) -> "Document":
        known, extra = {}, {}
        fields = set(cls._field_names())
        for k, v in d.items():
            if k in ("chunks", "matches") and isinstance(v, list):
                known[k] = [cls.from_docarray_dict(i) for i in v]
            elif k in fields and k != "extra":
                known[k] = v
            else:
                extra[k] = v
        doc = cls(**known)
        doc.extra = extra
        return doc


class DocumentArray:
    """List-like container of :class:`Document` with batch attribute
    access: iteration, indexing (int / slice / id), ``append`` /
    ``extend``, ``texts`` / ``tensors`` / ``tags`` views, dict/JSON round
    trip."""

    def __init__(self, docs: Optional[Iterable[Document]] = None):
        self._docs: List[Document] = list(docs) if docs is not None else []

    def __len__(self) -> int:
        return len(self._docs)

    def __iter__(self) -> Iterator[Document]:
        return iter(self._docs)

    def __getitem__(self, key: Union[int, slice, str]) -> Any:
        if isinstance(key, str):
            for d in self._docs:
                if d.id == key:
                    return d
            raise KeyError(key)
        if isinstance(key, slice):
            return DocumentArray(self._docs[key])
        return self._docs[key]

    def __setitem__(self, key: int, value: Document) -> None:
        self._docs[key] = value

    def __bool__(self) -> bool:
        return bool(self._docs)

    def __eq__(self, other) -> bool:
        if isinstance(other, DocumentArray):
            return self._docs == other._docs
        if isinstance(other, list):
            return self._docs == other
        return NotImplemented

    def append(self, doc: Document) -> None:
        self._docs.append(doc)

    def extend(self, docs: Iterable[Document]) -> None:
        self._docs.extend(docs)

    def clear(self) -> None:
        self._docs.clear()

    @property
    def texts(self) -> List[Optional[str]]:
        return [d.text for d in self._docs]

    @texts.setter
    def texts(self, values: Sequence[Optional[str]]) -> None:
        for d, v in zip(self._docs, values):
            d.text = v

    @property
    def tensors(self) -> List[Optional[np.ndarray]]:
        return [d.tensor for d in self._docs]

    @property
    def tags(self) -> List[Dict[str, Any]]:
        return [d.tags for d in self._docs]

    def to_dict(self) -> List[Dict[str, Any]]:
        return [d.to_dict() for d in self._docs]

    @classmethod
    def from_dict(cls, items: List[Dict[str, Any]], doc_cls=Document) -> "DocumentArray":
        return cls([doc_cls.from_dict(i) for i in items])

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "DocumentArray":
        return cls.from_dict(json.loads(s))

    def __repr__(self) -> str:
        return f"<DocumentArray ({len(self)} docs)>"

    def to_docarray_proto(self) -> Dict[str, Any]:
        """-> a ``docarray.DocListProto`` (dict form)."""
        return {"docs": [doc.to_docarray_proto() for doc in self._docs]}

    @classmethod
    def from_docarray_proto(cls, dlp: Dict[str, Any], doc_cls=Document) -> "DocumentArray":
        return cls([doc_cls.from_docarray_proto(d) for d in dlp.get("docs", [])])

    @staticmethod
    def empty(n: int) -> "DocumentArray":
        return DocumentArray([Document() for _ in range(n)])
