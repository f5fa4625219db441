"""K2 — fused attention kernel wrapper.

Replaces the TPU kernel ``marie_tpu/ops/pallas/flash_attention.py``
(``flash_attention``).  On CUDA tensors :func:`flash_attention` launches
the hand-written kernel of ``csrc/flash_attention.cu`` (D in {32, 64,
128}, float32 or bf16, any sequence lengths; both dtypes on tensor cores,
float32 as 3xTF32 products that keep float32 accuracy whatever torch's
TF32 switches say — see the source note).  On CPU tensors it runs the
plain PyTorch version, :func:`attention_reference` (the JAX
``_attention_reference``).  There is no fallback from one to the other.

Layout: q, k and v may be strided views (the encoder passes the
``[B,H,S,D]`` transposes of its ``[B,S,H,D]`` projections); the last
dimension must be contiguous and every row must start on a 16-byte
boundary, and the kernel reads them in place.  The output is the
``[B,H,Sq,D]`` view of a contiguous ``[B,Sq,H,D]`` tensor, so
``out.transpose(1, 2).reshape(B, Sq, H * D)`` is a view, not a copy.
Both versions return that layout.
"""

import ctypes
from typing import Optional

import torch

from marie_tpu_torch.ops.kernels import _build

_NEG_INF = -1e30
_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q, k, v, *, causal=False, kv_len=None, sm_scale=1.0):
    """Plain softmax(q k^T * sm_scale + masks) v: q [B,H,Sq,D], k/v
    [B,H,Skv,D]; logits, probabilities and sums in float32 for every input
    type, as in the TPU kernel (the JAX ``_attention_reference`` rounds
    bf16 logits to bf16; in float32 the two are the same function); output
    in q's dtype.  Masked logits are -1e30 (a fully masked row averages v
    uniformly).  Returns the ``[B,H,Sq,D]`` view of a contiguous
    ``[B,Sq,H,D]`` tensor, as the kernel does."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * sm_scale
    sq, skv = q.shape[2], k.shape[2]
    if kv_len is not None:
        pos = torch.arange(skv, device=q.device)
        mask = pos[None, None, None, :] < kv_len.to(q.device)[:, None, None, None]
        logits = torch.where(mask, logits, _NEG_INF)
    if causal:
        cm = (torch.arange(sq, device=q.device)[:, None]
              >= torch.arange(skv, device=q.device)[None, :] - (skv - sq))
        logits = torch.where(cm[None, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype).contiguous().transpose(1, 2)


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.mt_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
                       _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused attention. q [B,H,Sq,D], k/v [B,H,Skv,D] -> [B,H,Sq,D] (the
    transposed view of a contiguous [B,Sq,H,D] tensor).

    kv_len: optional [B] int valid kv lengths (right-padding mask).  On
    CUDA, q, k and v are read in place: each must have a contiguous last
    dimension, and its rows must start on 16-byte boundaries."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, kv_len=kv_len,
                                   sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share float32 or bf16")
    if d not in (32, 64, 128):
        raise ValueError(f"flash_attention: head width {d} not in (32, 64, 128)")
    if k.shape != (b, h, skv, d) or v.shape != k.shape or skv == 0:
        raise ValueError("flash_attention: k/v must be [B, H, Skv>0, D] like q")
    for t in (k, v) + ((kv_len,) if kv_len is not None else ()):
        if t.device != q.device:
            raise ValueError("flash_attention: all inputs must be on one device")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError("flash_attention: the last dimension of q, k, v "
                             "must be contiguous")
        per_16_bytes = 16 // t.element_size()
        if t.data_ptr() % 16 or any(s % per_16_bytes for s in t.stride()[:3]):
            raise ValueError("flash_attention: rows of q, k, v must start on "
                             "16-byte boundaries")
    kvl = None
    if kv_len is not None:
        if kv_len.shape != (b,):
            raise ValueError("flash_attention: kv_len must be [B]")
        kvl = kv_len.to(torch.int32).contiguous()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kvl.data_ptr() if kvl is not None else None, out.data_ptr(),
            strides, b, h, sq, skv, d, _DTYPES[q.dtype], float(sm_scale), int(causal),
            stream,
        )
    if b * h * sq > 0:
        _build.count_launch(flash_attention)
    _build.check(lib, code, "flash_attention")
    return out


#: launches of the CUDA kernel, in all and by path (the plain CPU path
#: does not count; see ``_build.count_launch``)
_build.reset_counts(flash_attention)
