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

Gradient: where grad mode is on and q, k or v requires a gradient, a CUDA
call goes through :class:`_FlashAttention`, a ``torch.autograd.Function``
whose forward is the float32 kernel's training instance (it also writes
each row's log-sum-exp: :func:`flash_attention_lse`) and whose backward is
the hand-written kernel of ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_backward`).  That path takes float32 at D in {32,
64} and raises on anything else; it never gives way to the plain version.
On the CPU autograd differentiates :func:`attention_reference`, which is
the plain version of both directions (the JAX package differentiates its
``_attention_reference`` the same way).  The backward's launches count on
the launch path its forward ran under (autograd runs it on a thread of
its own).
"""

import ctypes
from typing import Optional

import torch

from marie_tpu_torch.ops.kernels import _build

_NEG_INF = -1e30
_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _masked_logits(q, k, causal, kv_len, sm_scale):
    ct = torch.promote_types(q.dtype, torch.float32)  # float64 stays float64
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) * sm_scale
    sq, skv = q.shape[2], k.shape[2]
    if kv_len is not None:
        pos = torch.arange(skv, device=q.device)
        mask = pos[None, None, None, :] < kv_len.to(q.device)[:, None, None, None]
        logits = torch.where(mask, logits, _NEG_INF)
    if causal:
        cm = (torch.arange(sq, device=q.device)[:, None]
              >= torch.arange(skv, device=q.device)[None, :] - (skv - sq))
        logits = torch.where(cm[None, None], logits, _NEG_INF)
    return logits


def attention_reference(q, k, v, *, causal=False, kv_len=None, sm_scale=1.0):
    """Plain softmax(q k^T * sm_scale + masks) v: q [B,H,Sq,D], k/v
    [B,H,Skv,D]; logits, probabilities and sums in float32 for float32 and
    bf16 inputs, as in the TPU kernel (the JAX ``_attention_reference``
    rounds bf16 logits to bf16; in float32 the two are the same function),
    in float64 for float64 inputs (which the kernels do not take); output
    in q's dtype.  Masked logits are -1e30 (a fully masked row averages v
    uniformly).  Returns the ``[B,H,Sq,D]`` view of a contiguous
    ``[B,Sq,H,D]`` tensor, as the kernel does."""
    probs = torch.softmax(_masked_logits(q, k, causal, kv_len, sm_scale), dim=-1)
    out = torch.einsum("bhqk,bhkd->bqhd", probs, v.to(probs.dtype))
    return out.to(q.dtype).contiguous().transpose(1, 2)


def attention_lse_reference(q, k, v, *, causal=False, kv_len=None, sm_scale=1.0):
    """(out, lse): :func:`attention_reference` and each row's natural-log
    log-sum-exp of its scaled, masked logits, [B,H,Sq] in the logits'
    type (float32; float64 for float64 inputs).  A fully
    masked row's lse is that of its -1e30 logits (the kernel's is another
    value near -1e30: neither enters the gradient, see
    ``csrc/flash_attention_bwd.cu``)."""
    lse = torch.logsumexp(_masked_logits(q, k, causal, kv_len, sm_scale), dim=-1)
    return attention_reference(q, k, v, causal=causal, kv_len=kv_len, sm_scale=sm_scale), lse


def attention_backward_reference(q, k, v, dout, *, causal=False, kv_len=None, sm_scale=1.0):
    """(dq, dk, dv): autograd of :func:`attention_reference` at q, k, v
    with the output's gradient ``dout`` — the plain version of
    :func:`flash_attention_backward`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_reference(*leaves, causal=causal, kv_len=kv_len, sm_scale=sm_scale)
        return torch.autograd.grad(out, leaves, dout)


_LL = ctypes.POINTER(ctypes.c_longlong)
#: the float32 head widths the training path (forward with lse, backward) takes
TRAIN_HEAD_DIMS = (32, 64)


def _lib():
    lib = _build.load("flash_attention")
    if lib.mt_flash_attention.argtypes is None:
        lib.mt_flash_attention.argtypes = [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I,
                                           ctypes.c_float, _I, _P]
        lib.mt_flash_attention.restype = ctypes.c_int
        lib.mt_flash_attention_lse.argtypes = [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                                               _I, ctypes.c_float, _I, _P]
        lib.mt_flash_attention_lse.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    fn = lib.mt_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_LL, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(q, k, v, kv_len, what="flash_attention"):
    """Raise on what the CUDA kernels do not take; the int32 kv_len (or
    None)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k, v must share float32 or bf16")
    if d not in (32, 64, 128):
        raise ValueError(f"{what}: head width {d} not in (32, 64, 128)")
    if k.shape != (b, h, skv, d) or v.shape != k.shape or skv == 0:
        raise ValueError(f"{what}: k/v must be [B, H, Skv>0, D] like q")
    for t in (k, v) + ((kv_len,) if kv_len is not None else ()):
        if t.device != q.device:
            raise ValueError(f"{what}: all inputs must be on one device")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError(f"{what}: the last dimension of q, k, v must be contiguous")
        per_16_bytes = 16 // t.element_size()
        if t.data_ptr() % 16 or any(s % per_16_bytes for s in t.stride()[:3]):
            raise ValueError(f"{what}: rows of q, k, v must start on 16-byte boundaries")
    if kv_len is None:
        return None
    if kv_len.shape != (b,):
        raise ValueError(f"{what}: kv_len must be [B]")
    return kv_len.to(torch.int32).contiguous()


def _check_train(q, what):
    if q.dtype != torch.float32 or q.shape[3] not in TRAIN_HEAD_DIMS:
        raise ValueError(f"{what}: the training path takes float32 at a head width in "
                         f"{TRAIN_HEAD_DIMS}, got {q.dtype} at {q.shape[3]}")


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for t in tensors for s in t.stride()[:3]))


def _scale(d, sm_scale):
    return 1.0 / (d ** 0.5) if sm_scale is None else sm_scale


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
    dimension, and its rows must start on 16-byte boundaries.  With grad
    mode on and an input that requires a gradient, a CUDA call is
    differentiable (:class:`_FlashAttention`; float32, D in {32, 64})."""
    sm_scale = _scale(q.shape[3], sm_scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, kv_len=kv_len,
                                   sm_scale=sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        _check_train(q, "flash_attention")
        return _FlashAttention.apply(q, k, v, kv_len, causal, sm_scale)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    kvl = _check_cuda(q, k, v, kv_len)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kvl.data_ptr() if kvl is not None else None, out.data_ptr(),
            _strides(q, k, v, out), b, h, sq, skv, d, _DTYPES[q.dtype], float(sm_scale),
            int(causal), stream,
        )
    if b * h * sq > 0:
        _build.count_launch(flash_attention)
    _build.check(lib, code, "flash_attention")
    return out


def flash_attention_lse(q, k, v, kv_len=None, causal=False, sm_scale=None):
    """(out, lse): K2's float32 training forward, which also writes each
    row's log-sum-exp [B,H,Sq] (float32; natural log of the scaled, masked
    logits).  CPU tensors: :func:`attention_lse_reference`.  Its launches
    count as :func:`flash_attention`'s."""
    sm_scale = _scale(q.shape[3], sm_scale)
    if q.device.type == "cpu":
        return attention_lse_reference(q, k, v, causal=causal, kv_len=kv_len,
                                       sm_scale=sm_scale)
    _check_train(q, "flash_attention_lse")
    kvl = _check_cuda(q, k, v, kv_len, "flash_attention_lse")
    b, h, sq, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.mt_flash_attention_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kvl.data_ptr() if kvl is not None else None, out.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, out), b, h, sq, k.shape[2], d, float(sm_scale), int(causal),
            torch.cuda.current_stream().cuda_stream)
    if b * h * sq > 0:
        _build.count_launch(flash_attention)
    _build.check(lib, code, "flash_attention_lse")
    return out, lse


def flash_attention_backward(q, k, v, lse, dout, kv_len=None, causal=False, sm_scale=None):
    """(dq, dk, dv) of :func:`flash_attention` at q, k, v, given the rows'
    ``lse`` (:func:`flash_attention_lse`) and the output's gradient
    ``dout``.  CUDA tensors launch the kernels of
    ``csrc/flash_attention_bwd.cu`` (float32, D in {32, 64}; one count a
    call), which recompute each row's normaliser and ``Di`` from their own
    float32 S (the note there says why); CPU tensors take
    :func:`attention_backward_reference` (``lse`` unused).  The gradients
    are the [B,H,S,D] views of contiguous [B,S,H,D] tensors."""
    sm_scale = _scale(q.shape[3], sm_scale)
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, dout, causal=causal, kv_len=kv_len,
                                            sm_scale=sm_scale)
    _check_train(q, "flash_attention_backward")
    kvl = _check_cuda(q, k, v, kv_len, "flash_attention_backward")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if dout.shape != q.shape or lse.shape != (b, h, sq):
        raise ValueError("flash_attention_backward: dout must be shaped like q, lse [B, H, Sq]")
    if (dout.dtype != torch.float32 or dout.stride(3) != 1 or dout.data_ptr() % 16
            or any(s % 4 for s in dout.stride()[:3])):
        dout = dout.float().contiguous()  # the kernels copy its rows 16 bytes at a time
    lse = lse.float().contiguous()
    stats = torch.empty((2, b, h, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=torch.float32,
                              device=q.device).transpose(1, 2) for s in (sq, skv, skv))
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        code = lib.mt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            kvl.data_ptr() if kvl is not None else None, stats.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, dout, dq, dk, dv), b, h, sq, skv,
            d, float(sm_scale), int(causal), torch.cuda.current_stream().cuda_stream)
    if b * h * sq > 0:
        _build.count_launch(flash_attention_backward)
    _build.check(lib, code, "flash_attention_backward")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K2 under autograd on the card: forward :func:`flash_attention_lse`,
    backward :func:`flash_attention_backward`, counted on the launch path
    the forward ran under."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, sm_scale):
        out, lse = flash_attention_lse(q, k, v, kv_len, causal, sm_scale)
        ctx.save_for_backward(q, k, v, lse, kv_len)
        ctx.causal, ctx.sm_scale, ctx.path = causal, sm_scale, _build.current_path()
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, kv_len = ctx.saved_tensors
        with _build.launch_path(ctx.path):
            dq, dk, dv = flash_attention_backward(q, k, v, lse, dout, kv_len, ctx.causal,
                                                  ctx.sm_scale)
        return dq, dk, dv, None, None, None


#: launches of the CUDA kernels, in all and by path (the plain CPU path
#: does not count; see ``_build.count_launch``)
_build.reset_counts(flash_attention, flash_attention_backward)
