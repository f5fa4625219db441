"""The arithmetic K2's float32 kernel (``csrc/flash_attention.cu``,
``flash_tf32_kernel``) rests on, emulated on the CPU, since the kernel
itself runs only on the card (``test_torch_cuda.py`` holds it to its
plain version there).

(a) 3xTF32: each operand splits into TF32 values hi + lo and each product
is lo*hi + hi*lo + hi*hi, which keeps attention within 1e-5 of float64
where one TF32 product per pair misses 1e-4.  Shown for the kernel's
split (truncation) and for round-half-away (``cvt.rna.tf32.f32``).

(b) The loop: 64-row blocks, key tiles with an online softmax in the
log2 domain, tiles past ``kv_len`` and above the causal diagonal skipped
unless the block holds a fully masked row.  It equals
``attention_reference`` and the JAX ``_attention_reference``; skipping
for a fully masked row, as the Pallas kernel does, would not.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from marie_tpu.ops.pallas.flash_attention import _attention_reference
from marie_tpu_torch.ops.kernels.flash_attention import attention_reference

_MASK = np.uint32(0xFFFFE000)  # a TF32 value keeps the top 19 bits
_LOG2E = 1.4426950408889634


def tf32(x: np.ndarray, rounding: str) -> np.ndarray:
    """float32 -> the nearest TF32 value by bit masking: "trunc" clears
    the low 13 bits (the kernel's split), "rna" rounds half away from
    zero first (``cvt.rna.tf32.f32``)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if rounding == "rna":
        bits = bits + np.uint32(0x1000)
    return (bits & _MASK).view(np.float32)


def split(x: np.ndarray, rounding: str):
    hi = tf32(x, rounding)
    return hi, tf32(x - hi, rounding)


def matmul_tf32(a: np.ndarray, b: np.ndarray, rounding: str, terms: int) -> np.ndarray:
    """a @ b from TF32 products (exact in float64), summed and rounded to
    float32: ``terms`` 3 is 3xTF32 (lo*hi + hi*lo + hi*hi), 1 plain TF32."""
    ah, al = split(a, rounding)
    bh, bl = split(b, rounding)
    f64 = lambda x, y: x.astype(np.float64) @ y.astype(np.float64)
    out = f64(ah, bh)
    if terms == 3:
        out += f64(al, bh) + f64(ah, bl)
    return out.astype(np.float32)


def attention_tf32(q, k, v, kv_len, rounding, terms):
    """softmax(q kᵀ / sqrt(D) + kv_len mask) v for one head, both products
    in TF32, softmax in float32."""
    s = matmul_tf32(q, k.T, rounding, terms) * np.float32(1.0 / math.sqrt(q.shape[-1]))
    s[:, kv_len:] = np.float32(-1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return matmul_tf32(p, v, rounding, terms)


def attention_f64(q, k, v, kv_len):
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = q @ k.T / math.sqrt(q.shape[-1])
    s[:, kv_len:] = -np.inf
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


@pytest.mark.parametrize("rounding", ["trunc", "rna"])
def test_tf32_split_holds_float32(rounding):
    """hi and lo are TF32 values and hi + lo is x within 2^-20 relative
    (2^-22 with rounding), over every binade that attention meets."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000) * np.exp2(rng.integers(-30, 30, 100_000))).astype(np.float32)
    hi, lo = split(x, rounding)
    assert not (hi.view(np.uint32) & ~_MASK).any() and not (lo.view(np.uint32) & ~_MASK).any()
    rel = np.abs(x.astype(np.float64) - hi - lo) / np.abs(x)
    assert rel.max() < 2.0 ** (-20 if rounding == "trunc" else -22)
    assert np.abs(x - tf32(x, rounding)).max() > 0  # one TF32 value alone does not


@pytest.mark.parametrize("rounding", ["trunc", "rna"])
@pytest.mark.parametrize("d", [64, 128])
def test_3xtf32_attention_within_float32_limits(d, rounding):
    """At the base classifier's 708 tokens (and D=128), with kv_len cuts:
    3xTF32 QKᵀ and PV stay within 1e-5 of float64 attention, while plain
    TF32 misses K2's float32 limit of 1e-4."""
    rng = np.random.default_rng(d)
    s = 708
    q, k, v = (rng.standard_normal((s, d)).astype(np.float32) for _ in range(3))
    for kv_len in (708, 300, 5):
        want = attention_f64(q, k, v, kv_len)
        err3 = np.abs(attention_tf32(q, k, v, kv_len, rounding, 3) - want).max()
        err1 = np.abs(attention_tf32(q, k, v, kv_len, rounding, 1) - want).max()
        assert err3 <= 1e-5, (kv_len, err3)
        assert err1 > 1e-4, (kv_len, err1)


def tiled_attention(q, k, v, *, causal=False, kv_len=None, sm_scale=1.0, skip_masked_rows=False):
    """``flash_tf32_kernel``'s loop in float32 torch (exact products: this
    pins the loop, not the split).  q [B,H,Sq,D], k/v [B,H,Skv,D].
    Returns (out [B,H,Sq,D], key tiles visited, key tiles in all).  With
    ``skip_masked_rows`` a block with a fully masked row stops at its last
    row's limit too, as ``_flash_kernel`` does for causal blocks."""
    b_n, _, sq, d = q.shape
    skv = k.shape[2]
    kt = {32: 64, 64: 32, 128: 16}[d]  # the kernel's key tile by D
    rows = 64
    scale_log2 = sm_scale * _LOG2E
    out = torch.empty_like(q)
    visited = total = 0
    for b in range(b_n):
        kvl = skv if kv_len is None else max(0, min(int(kv_len[b]), skv))

        def lim(qi):
            return min(kvl, max(0, qi + skv - sq + 1)) if causal else kvl

        for q0 in range(0, sq, rows):
            q1 = min(q0 + rows, sq)
            kend = skv if lim(q0) == 0 and not skip_masked_rows else lim(q1 - 1)
            tiles = -(-kend // kt)
            visited += tiles
            total += -(-skv // kt)
            row_lim = torch.tensor([lim(i) for i in range(q0, q1)])[:, None]
            qb = q[b, :, q0:q1]
            m = torch.full(qb.shape[:2], -math.inf)
            l = torch.zeros(qb.shape[:2])
            acc = torch.zeros(qb.shape)
            for it in range(tiles):
                t0 = it * kt
                keys = torch.arange(t0, t0 + kt)
                # rows at or past kend are staged as zeros
                kb = torch.zeros(k.shape[1], kt, d)
                vb = torch.zeros(k.shape[1], kt, d)
                n = min(kend, t0 + kt) - t0
                kb[:, :n], vb[:, :n] = k[b, :, t0:t0 + n], v[b, :, t0:t0 + n]
                s = (qb @ kb.transpose(-1, -2)) * scale_log2
                masked = torch.where(keys < skv, torch.tensor(-1e30), torch.tensor(-math.inf))
                s = torch.where(keys[None, :] >= row_lim, masked, s)
                tile_max = torch.maximum(m, s.amax(-1))
                if it > 0:
                    alpha = torch.exp2(m - tile_max)
                    l, acc = l * alpha, acc * alpha[..., None]
                m = tile_max
                p = torch.exp2(s - m[..., None])
                l = l + p.sum(-1)
                acc = acc + p @ vb
            out[b, :, q0:q1] = acc / l[..., None]
    return out, visited, total


@pytest.mark.parametrize("d,sq,skv,causal,kv_len,skips", [
    # the base classifier's shape with kv_len at and around tile edges, 0 and Skv
    (64, 708, 708, False, [1, 63, 64, 65, 708, 0, 300], True),
    (64, 512, 512, False, [1, 512, 200], True),  # the base indexer's windows
    (64, 192, 192, False, [33, 165, 0, 192], True),  # the chain heads
    # causal Sq > Skv: rows 0-79 fully masked, so the first two blocks walk
    # every key, and the third block's last row sees them all
    (32, 150, 70, True, None, False),
    (128, 150, 70, True, [70, 0, 40], True),
    (128, 37, 53, True, [53, 1, 20], True),  # Sq < Skv, bottom-right diagonal
    (64, 20, 20, False, None, False),  # the encoder's shape, one tile
])
def test_tiled_loop_with_skipped_tiles_matches_references(d, sq, skv, causal, kv_len, skips):
    """The loop equals ``attention_reference`` and the JAX
    ``_attention_reference`` within 1e-6 (fully masked rows average V over
    all of Skv), visits fewer tiles where a mask cuts whole tiles off a
    block, and would not match if it skipped for fully masked rows."""
    rng = np.random.default_rng(d + sq + skv)
    b, h = (len(kv_len) if kv_len else 2), 2
    q = (rng.standard_normal((b, h, sq, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, h, skv, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    kvl = None if kv_len is None else np.asarray(kv_len, np.int32)
    scale = 1.0 / d ** 0.5
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tkv = None if kvl is None else torch.from_numpy(kvl)
    got, visited, total = tiled_attention(tq, tk, tv, causal=causal, kv_len=tkv, sm_scale=scale)
    want = attention_reference(tq, tk, tv, causal=causal, kv_len=tkv, sm_scale=scale)
    jax_want = _attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, sm_scale=scale,
                                    kv_len=None if kvl is None else jnp.asarray(kvl))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_want), atol=1e-6, rtol=0)
    assert (visited < total) == skips, (visited, total)

    empty = (kvl == 0).any() if kvl is not None else False
    empty = empty or (causal and sq > skv)
    if empty:  # the trap: such rows must walk every key
        naive, _, _ = tiled_attention(tq, tk, tv, causal=causal, kv_len=tkv, sm_scale=scale,
                                      skip_masked_rows=True)
        assert not torch.allclose(naive, want, atol=1e-3)
