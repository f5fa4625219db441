"""Fused OCR -> classify -> NER chain (port of
``marie_tpu/ocr/fused_chain.py``): a page group runs the page program of
:mod:`marie_tpu_torch.ocr.fused` (detect, keep, compact, K1 crops,
encode, greedy decode), then, without leaving the device, hashes each
decoded row to a LayoutLM word id (the device side of
:class:`~marie_tpu_torch.components.word_tokenizer.RollingWordTokenizer`),
gathers each page's kept rows into a fixed-length sequence with their
bucketed boxes, and runs the classification and token-classification
heads (float32, K2 in every layer with a ``kv_len`` mask).

Row alignment: the same as the page program's (page-major kept-first);
page p's j-th kept row is ``ner_labels[p, j]``, for j < the heads'
sequence cap.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from marie_tpu_torch.components.word_tokenizer import _RESERVED
from marie_tpu_torch.ocr.fused import _norm_pack_bits, compact_program, program_args
from marie_tpu_torch.ops.kernels._build import launch_path
from marie_tpu_torch.utils.device import float32_precision


def rolling_word_ids(tokens: torch.Tensor, vocab_size: int, pad_id: int = 2) -> torch.Tensor:
    """[T, S] decoded char ids -> [T] int32 word ids: h = sum over non-pad
    chars of (tok + 1) * 31^pos mod 2^32, id = 2 + h mod (vocab - 2).
    The JAX version wraps in uint32; here the terms (< 2^41) and their
    sum (< 2^46 for S <= 32) fit int64, masked to 32 bits before the
    modulo, which gives the same residue."""
    s = tokens.shape[-1]
    pows = torch.tensor([pow(31, i, 1 << 32) for i in range(s)], dtype=torch.int64,
                        device=tokens.device)
    t = tokens.to(torch.int64)
    contrib = torch.where(t != pad_id, (t + 1) * pows, 0)
    h = contrib.sum(dim=-1) & 0xFFFFFFFF
    return (_RESERVED + h % (vocab_size - _RESERVED)).to(torch.int32)


@torch.no_grad()
def fused_pages_chain(craft_model: nn.Module, trocr_model: nn.Module, cls_model: nn.Module,
                      ner_model: nn.Module, pages_u8: torch.Tensor, clip_whs: torch.Tensor,
                      n_real: int, *program, seq_len_cap: int, word_vocab: int,
                      coord_buckets: int, **program_kw):
    """The page program (``program`` / ``program_kw`` are
    :func:`~marie_tpu_torch.ocr.fused.compact_program`'s arguments after
    ``n_real``), then the heads on its rows.

    Returns (stats, tokens, conf, cls_logits [P, classes] float32,
    ner_labels [P, seq_len_cap] int32, ner_scores [P, seq_len_cap]
    float32)."""
    stats, tokens, conf, (keep, b, clip) = compact_program(
        craft_model, trocr_model, pages_u8, clip_whs, n_real, *program, **program_kw)
    total_slots = tokens.shape[0]
    word_ids = rolling_word_ids(tokens, word_vocab)  # [T]
    # xyxy boxes in coordinate buckets, in the JAX order of operations
    # (divide, multiply, truncate toward zero)
    scale4 = torch.cat([clip, clip], dim=-1)  # w, h, w, h
    nbox = torch.clamp((b / torch.clamp(scale4, min=1.0) * (coord_buckets - 1)).to(torch.int32),
                       0, coord_buckets - 1)
    # page p's kept rows start at the kept count of pages < p
    counts = keep.sum(dim=1)
    offsets = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(seq_len_cap, device=tokens.device)
    rows = torch.clamp(offsets[:, None] + pos[None, :], 0, total_slots - 1)
    valid = pos[None, :] < counts[:, None]
    page_tokens = torch.where(valid, word_ids[rows], 0)  # PAD_ID = 0
    page_boxes = torch.where(valid[..., None], nbox[rows], 0)
    seq_len = torch.clamp(counts, min=1, max=seq_len_cap).to(torch.int32)
    with record_function("marie.heads"), launch_path("heads"), float32_precision(False):
        cls_logits = cls_model(page_tokens, page_boxes, seq_len)
        ner_logits = ner_model(page_tokens, page_boxes, seq_len)
        ner_scores = torch.softmax(ner_logits, dim=-1).amax(dim=-1)
        ner_labels = torch.argmax(ner_logits, dim=-1).to(torch.int32)
    return stats, tokens, conf, cls_logits, ner_labels, ner_scores


def fused_ocr_chain(box_processor, ocr_processor, classifier, indexer, pages, clip_whs=None,
                    *, n_real: Optional[int] = None, total_slots: Optional[int] = None,
                    compact_slots: int = 192, mesh=None, packed=False):
    """The chained program over one same-bucket page batch with the
    settings of the two processors and two heads (``classifier`` /
    ``indexer``: a :class:`LayoutDocumentClassifier` and a
    :class:`LayoutDocumentIndexer` trained with the RollingWordTokenizer;
    their ``.model``, ``.config`` and ``.device`` are read).  The
    sequence cap is the smaller ``max_seq_len`` of the two.  Arguments as
    :func:`~marie_tpu_torch.ocr.fused.fused_ocr_pages`.

    Returns (stats, tokens, conf, cls_logits, ner_labels, ner_scores) on
    the device."""
    if mesh is not None:
        raise NotImplementedError("a device mesh is ROADMAP §1 item 16")
    bp, op = box_processor, ocr_processor
    if classifier.config.vocab_size != indexer.config.vocab_size:
        raise ValueError("the classifier and the indexer must share one word vocabulary")
    for head in (classifier, indexer):
        if head.device != bp.device:
            raise ValueError(f"the heads run on the detector's device {bp.device}, "
                             f"got {head.device}")
    pack_bits = _norm_pack_bits(packed)
    p = int(pages.shape[0])
    if clip_whs is None:
        h = int(pages.shape[1])
        w = int(pages.shape[2]) * (8 // pack_bits if pack_bits else 1)
        clip_whs = np.tile(np.asarray([[w, h]], np.float32), (p, 1))
    pages = torch.as_tensor(pages).to(bp.device)
    clip_whs = torch.as_tensor(clip_whs, dtype=torch.float32).to(bp.device)
    total_slots = p * compact_slots if total_slots is None else total_slots
    with launch_path("fused"):
        return fused_pages_chain(
            bp.model, op.model, classifier.model, indexer.model, pages, clip_whs,
            p if n_real is None else int(n_real), *program_args(bp, op, total_slots),
            packed=pack_bits, cc_runs=bp.cc_runs, allow_tf32=bp.allow_tf32,
            seq_len_cap=min(classifier.config.max_seq_len, indexer.config.max_seq_len),
            word_vocab=int(classifier.config.vocab_size),
            coord_buckets=int(classifier.config.max_2d_pos))
