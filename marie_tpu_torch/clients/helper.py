"""Client-side input handling (copy of ``marie_tpu/clients/helper.py``):
any iterable of documents, chunked into fixed-size requests."""

from typing import List

from marie_tpu_torch.types.docs import DocumentArray


def as_docarray(inputs) -> DocumentArray:
    """Accept DocumentArray | list | generator | None: any iterable of
    Documents, lazy generators included."""
    if inputs is None:
        return DocumentArray()
    if isinstance(inputs, DocumentArray):
        return inputs
    da = DocumentArray()
    for d in inputs:
        da.append(d)
    return da


def chunk_docs(docs: DocumentArray, request_size: int) -> List[DocumentArray]:
    """Split into requests of ``request_size`` docs (0 = one request)."""
    if request_size <= 0 or len(docs) <= request_size:
        return [docs]
    chunks: List[DocumentArray] = []
    cur = DocumentArray()
    for d in docs:
        cur.append(d)
        if len(cur) == request_size:
            chunks.append(cur)
            cur = DocumentArray()
    if len(cur):
        chunks.append(cur)
    return chunks
