"""The port's documents and requests (``marie_tpu_torch.types``,
``marie_tpu_torch.api.docs``) against the JAX package's pydantic ones:
the JSON of ``Document``, ``DocumentArray`` and the API docs is equal
byte for byte (key order, defaults, the ndarray and bytes encodings),
each package reads the other's JSON back to the same bytes, and
``DataRequest`` keeps the JAX request's fields, status and routes."""

import json

import numpy as np
import pytest
import torch

from marie_tpu.api import docs as japi
from marie_tpu.types.docs import Document as JDocument
from marie_tpu.types.docs import DocumentArray as JDocumentArray
from marie_tpu.types.request import DataRequest as JDataRequest
from marie_tpu.types.request import ts_iso as jts_iso
from marie_tpu_torch.api import docs as tapi
from marie_tpu_torch.types.docs import Document, DocumentArray
from marie_tpu_torch.types.request import DataRequest, Status


def _doc_kwargs(case: str):
    rng = np.random.default_rng(len(case))
    base = {"id": f"doc-{case}"}
    if case == "uint8":
        return {**base, "tensor": rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)}
    if case == "float32":
        return {**base, "tensor": rng.standard_normal((3, 4)).astype(np.float32),
                "embedding": rng.standard_normal(6)}
    if case == "tags":
        return {**base, "tags": {"words": ["a", "b"], "boxes": [[1, 2, 3, 4], (5, 6, 7, 8)],
                                 "nested": {"x": np.int64(3), "y": np.float32(0.1),
                                            "z": [np.uint8(7), None, True]},
                                 "arr": np.arange(4, dtype=np.int16), "raw": b"\x00\xff"}}
    if case == "bytes_text_uri":
        return {**base, "blob": bytes(range(40)), "text": "héllo wörld", "uri": "file:///x.tif",
                "mime_type": "image/tiff", "modality": "image", "parent_id": "p"}
    if case == "children":
        return {**base, "chunks": [{"id": "c1", "text": "t1", "tags": {"k": 1}}],
                "matches": [{"id": "m1", "scores": {"s": 1}}], "scores": {"cos": 2}}
    return base


CASES = ["plain", "uint8", "float32", "tags", "bytes_text_uri", "children"]


@pytest.mark.parametrize("case", CASES)
def test_document_json_is_jax_bytes(case):
    kw = _doc_kwargs(case)
    want = JDocument(**kw).to_json()
    got = Document(**kw).to_json()
    assert got == want
    # round trips, and each package reads the other's JSON to the same bytes
    assert Document.from_json(got).to_json() == want
    assert Document.from_json(want).to_json() == JDocument.from_json(got).to_json() == want


def test_document_defaults_and_coercions():
    """Default id (uuid4 hex), a torch tensor becomes numpy, a list
    tensor becomes an array, nested dicts become Documents, scores become
    floats, keys that are not fields are ignored on from_dict."""
    d = Document()
    assert len(d.id) == 32 and int(d.id, 16) >= 0 and d.id != Document().id
    assert list(d.to_dict()) == list(JDocument().to_dict())
    t = Document(tensor=torch.arange(6).reshape(2, 3), embedding=[1.0, 2.0])
    assert isinstance(t.tensor, np.ndarray) and t.tensor.dtype == np.int64
    assert isinstance(t.embedding, np.ndarray)
    c = Document(id="p", chunks=[{"id": "c", "text": "x"}], scores={"a": 1})
    assert isinstance(c.chunks[0], Document) and c.scores == {"a": 1.0}
    d2 = Document.from_dict({"id": "q", "text": "t", "unknown": 5})
    assert d2.to_json() == JDocument.from_dict({"id": "q", "text": "t", "unknown": 5}).to_json()
    assert Document(id="a") == Document(id="a") and Document(id="a") != Document(id="b")
    assert hash(Document(id="a")) == hash("a")
    assert repr(Document(id="abcdefghij", text="hi", tensor=np.zeros((2, 2)))) == repr(
        JDocument(id="abcdefghij", text="hi", tensor=np.zeros((2, 2))))


def test_document_array_matches_jax():
    kws = [_doc_kwargs(c) for c in CASES]
    got = DocumentArray([Document(**kw) for kw in kws])
    want = JDocumentArray([JDocument(**kw) for kw in kws])
    assert got.to_json() == want.to_json()
    assert DocumentArray.from_json(want.to_json()).to_json() == want.to_json()
    assert got["doc-tags"].id == "doc-tags" and len(got[1:3]) == 2 and got[0].id == "doc-plain"
    with pytest.raises(KeyError):
        got["missing"]
    got.texts = [str(i) for i in range(len(got))]
    assert got.texts == [str(i) for i in range(len(kws))]
    assert [t is None for t in got.tensors] == [t is None for t in want.tensors]
    assert got.tags == [d.tags for d in got]
    assert DocumentArray.empty(3).to_dict().__len__() == 3 and not DocumentArray()
    assert repr(got) == repr(want)


@pytest.mark.parametrize("name,kw", [
    ("StorageDoc", {"id": "s", "content": {"a": [1, 2]}, "tags": {"t": 1},
                    "embedding": [0.5, 1.5], "blob": b"zz"}),
    ("StorageDoc", {"id": "s2"}),
    ("AssetKeyDoc", {"id": "a", "asset_key": "s3://b/k.tif", "pages": [1, 3]}),
    ("MarieDoc", {"id": "m", "tags": {"x": 1}, "tensor": np.ones((2, 2), np.uint8)}),
    ("BatchableMarieDoc", {"id": "b", "words": ["w"], "boxes": [[0, 0, 1, 1]]}),
    ("OutputDoc", {"id": "o", "jobid": "j1", "status": "done"}),
])
def test_api_docs_json_is_jax_bytes(name, kw):
    want = getattr(japi, name)(**kw).to_json()
    assert getattr(tapi, name)(**kw).to_json() == want
    assert getattr(tapi, name).from_json(want).to_json() == want
    assert tapi.DOC_KEY_ASSET_KEY == japi.DOC_KEY_ASSET_KEY == "asset_key"


def test_data_request_matches_jax():
    docs = [dict(id="r1", text="a"), dict(id="r2", tensor=np.zeros((2, 2), np.uint8))]
    params = {"job_id": "j", "nested": {"k": [1, 2]}}
    j = JDataRequest.from_docs(JDocumentArray([JDocument(**d) for d in docs]),
                               endpoint="/document/extract", parameters=params,
                               target_executor="exec.*")
    t = DataRequest.from_docs([Document(**d) for d in docs], endpoint="/document/extract",
                              parameters=params, target_executor="exec.*")
    for attr in ("exec_endpoint", "target_executor", "parameters", "is_error", "doc_count"):
        a, b = getattr(t, attr), getattr(j, attr)
        assert (a() if callable(a) else a) == (b() if callable(b) else b), attr
    assert t.docs.to_json() == j.docs.to_json()
    assert len(t.request_id) == 32 and t.request_id != DataRequest().request_id
    bare, jbare = DataRequest(), JDataRequest()
    assert (bare.exec_endpoint, bare.target_executor, bare.parameters, len(bare.docs)) == (
        jbare.exec_endpoint, jbare.target_executor, jbare.parameters, len(jbare.docs))

    try:
        raise ValueError("bad", 3)
    except ValueError as ex:
        t.add_exception(ex, executor="X")
        j.add_exception(ex, executor="X")
    st, jst = t.status, j.status
    assert t.is_error() and j.is_error() and st.code == int(jst.code) == Status.ERROR
    assert (st.description, st.exception.name, list(st.exception.args), st.exception.executor) \
        == (jst.description, jst.exception.name, list(jst.exception.args),
            jst.exception.executor)
    assert st.exception.stacks[-1] == list(jst.exception.stacks)[-1]

    for start, end in [("2026-10-18T05:57:24.123456+00:00", "2026-10-18T07:57:25+02:00"),
                       ("2026-01-02T03:04:05", "")]:
        t.add_route("w", start, end)
        j.add_route("w", start, end)
    assert [(r.executor, r.start_time, r.end_time) for r in t.routes] == [
        (r.executor, jts_iso(r.start_time), jts_iso(r.end_time)) for r in j.routes]
    t.parameters = None
    assert t.parameters == {}
    t.docs = [Document(id="z")]
    assert isinstance(t.docs, DocumentArray) and t.docs[0].id == "z"


def test_wire_forms_wait_for_the_grpc_item():
    """The protobuf methods raise, naming ROADMAP item 10."""
    for call in (lambda: DataRequest().to_bytes(), lambda: DataRequest.from_bytes(b""),
                 lambda: Document().to_docarray_proto(),
                 lambda: DocumentArray().to_docarray_proto(),
                 lambda: Document.from_docarray_dict({})):
        with pytest.raises(NotImplementedError, match="item 10"):
            call()
    assert json.loads(Document(id="x").to_json())["id"] == "x"
