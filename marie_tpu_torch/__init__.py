"""PyTorch/CUDA port of marie_tpu's page OCR.

The JAX package (``marie_tpu``) stays the reference; this package runs its
serving engine on an NVIDIA GPU: ``PipelineOcrEngine`` over a
``BoxProcessorCraft`` (page prep, CRAFT, run-domain connected components)
and a ``TrOcrProcessor`` (word crops, TrOCR encoder and greedy decode),
with packed uploads, the fused page-group program streamed on a worker
thread, line organisation and the JAX package's result schema; the
LayoutLM classification and NER heads chained into that program, and the
document classifier, indexer and splitter on their own; the
classification pipeline (``pipe/``) and the layout embeddings
(``embeddings/``).  It imports torch, numpy and the standard library
only.

Importing the package builds nothing: the CUDA kernels under ``csrc/`` are
compiled with ``nvcc`` the first time a wrapper launches one
(:mod:`marie_tpu_torch.ops.kernels._build`).
"""

__all__ = ["PipelineOcrEngine"]


def __getattr__(name):
    if name == "PipelineOcrEngine":
        from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine

        return PipelineOcrEngine
    raise AttributeError(f"module 'marie_tpu_torch' has no attribute {name!r}")
