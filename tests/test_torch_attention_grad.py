"""K2's gradient (``marie_tpu_torch/ops/kernels/flash_attention.py``) on
the CPU, against the JAX package's.

* The plain version of both directions (autograd of
  ``attention_reference``, which ``flash_attention`` and
  ``flash_attention_backward`` run on CPU tensors) against ``jax.grad`` of
  ``marie_tpu.ops.pallas.flash_attention.flash_attention`` (its reference
  path on the CPU, as JAX differentiates it at these head widths): dq, dk
  and dv within 1e-5 of each one's largest magnitude, at D 32 and 64, with
  kv_len holding a fully masked row, and causal with Sq > Skv (rows above
  the diagonal fully masked) and Sq < Skv.
* The training forward's log-sum-exp (``flash_attention_lse``) against
  JAX's on the rows that see a key.
* Numpy emulations of the CUDA backward's tiled algorithm
  (``csrc/flash_attention_bwd.cu``: each row's normaliser and Di
  recomputed from its own S under the forward's lse, P and dS from them, a
  fully masked row's P 1/Skv and dS 0, the query tiles the dk/dv pass
  skips, the key tiles the dq pass walks) against the same gradients: the
  kernel cannot run here, its arithmetic can.  Two cases of one test: the
  float32 form with 32-row tiles, and the tensor-core form the kernel
  runs (every product in 3xTF32, 64-row blocks, S^T = K Q^T in the dk/dv
  pass, dq taken on the keys less key 0).
* The reading-order ranker's geometry (keys a shared key + 1e-3 noise),
  where dq = sum_j dS_ij k_j cancels: the tensor-core emulation's dq is no
  worse against float64 than twice the plain float32 gradient's own error,
  while Di = rowsum(do * o) from the forward's output misses that bound
  (why the kernel recomputes each row's statistics).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from marie_tpu_torch.ops.kernels import flash_attention as k2

LIMIT = 1e-5
CASES = [  # (B, H, Sq, Skv, D, causal, kv_len)
    (3, 2, 40, 40, 32, False, [40, 17, 0]),
    (3, 2, 40, 40, 64, False, [0, 33, 40]),
    (2, 2, 45, 30, 64, True, None),  # Sq > Skv: the first 15 rows see no key
    (2, 3, 20, 70, 32, True, [55, 0]),
    (2, 2, 37, 37, 64, True, [37, 20]),
]


def _inputs(b, h, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for s in (sq, skv, skv, sq)]


def _jax_grads(q, k, v, do, causal, kv_len):
    kvl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)

    def f(q, k, v):
        return jax_flash_attention(q, k, v, kv_len=kvl, causal=causal)

    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert np.abs(got - want).max() <= LIMIT * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("case", CASES)
def test_plain_gradient_matches_jax(case):
    b, h, sq, skv, d, causal, kv_len = case
    q, k, v, do = _inputs(b, h, sq, skv, d, sum(case[:5]))
    jout, jgrads = _jax_grads(q, k, v, do, causal, kv_len)
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = k2.flash_attention(*leaves, kv_len=kvl, causal=causal)
    _close(out, jout)
    out.backward(torch.from_numpy(do))
    for t, w in zip(leaves, jgrads):
        _close(t.grad, w)
    # the backward wrapper's plain version is the same gradient
    plain = k2.flash_attention_backward(*(torch.from_numpy(a) for a in (q, k, v)), None,
                                        torch.from_numpy(do), kvl, causal)
    for g, w in zip(plain, jgrads):
        _close(g, w)
    assert k2.flash_attention.launches == 0 and k2.flash_attention_backward.launches == 0


@pytest.mark.parametrize("case", CASES)
def test_lse_matches_jax(case):
    b, h, sq, skv, d, causal, kv_len = case
    q, k, v, _ = _inputs(b, h, sq, skv, d, sum(case[:5]))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    out, lse = k2.flash_attention_lse(*(torch.from_numpy(a) for a in (q, k, v)), kvl, causal)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(d)
    sees = _limits(b, sq, skv, causal, kv_len)
    keys = np.arange(skv)[None, None, :] < sees[:, :, None]  # [B, Sq, Skv]
    want = jax.nn.logsumexp(jnp.where(jnp.asarray(keys)[:, None], logits, -jnp.inf), axis=-1)
    rows = np.broadcast_to((sees > 0)[:, None, :], lse.shape)
    np.testing.assert_allclose(lse.numpy()[rows], np.asarray(want)[rows], rtol=0, atol=LIMIT)
    _close(out, _jax_grads(q, k, v, q, causal, kv_len)[0])


def _limits(b, sq, skv, causal, kv_len):
    """[B, Sq]: row i sees keys [0, lim)."""
    kvl = np.full(b, skv) if kv_len is None else np.minimum(np.asarray(kv_len), skv)
    lim = np.broadcast_to(kvl[:, None], (b, sq)).copy()
    if causal:
        lim = np.minimum(lim, np.maximum(0, np.arange(sq)[None, :] + (skv - sq) + 1))
    return lim


def _emulate_backward(q, k, v, do, lse, kv_len, causal, scale, tile=32):
    """The CUDA backward's algorithm, tile by tile, in float32: the dq pass
    (pass 1: each row's sum of p = exp(S * scale - lse) and of p dP, giving
    its own lse and Di; pass 2: dq), then the dk/dv pass over key tiles.
    Returns (dq, dk, dv, the rows' dS sums)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    lim = _limits(b, sq, skv, causal, kv_len)
    lse = lse.copy()
    di = np.zeros_like(lse)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    ds_sum = np.zeros_like(lse)

    def tile_sp(bi, hi, i0, j0):
        i = np.arange(i0, min(i0 + tile, sq))
        j = np.arange(j0, min(j0 + tile, skv))
        li = lim[bi, i][:, None]
        return (i, j, li, j[None, :] < li, q[bi, hi, i] @ k[bi, hi, j].T,
                do[bi, hi, i] @ v[bi, hi, j].T)

    def p_ds(bi, hi, i0, j0):
        i, j, li, seen, s, dp = tile_sp(bi, hi, i0, j0)
        p = np.exp(np.where(seen, s * scale - lse[bi, hi, i][:, None], -np.inf))
        p = np.where(li == 0, np.float32(1.0 / skv), p).astype(np.float32)
        ds = np.where(seen, p * (dp - di[bi, hi, i][:, None]) * scale, 0.0)
        return i, j, p, ds.astype(np.float32)

    for bi in range(b):
        for hi in range(h):
            for i0 in range(0, sq, tile):  # dq: one block a query tile
                kend = lim[bi, min(i0 + tile, sq) - 1]
                i = np.arange(i0, min(i0 + tile, sq))
                l_sum, d_sum = np.zeros(len(i), np.float32), np.zeros(len(i), np.float32)
                for j0 in range(0, kend, tile):  # pass 1
                    _, _, _, seen, s, dp = tile_sp(bi, hi, i0, j0)
                    p = np.exp(np.where(seen, s * scale - lse[bi, hi, i][:, None], -np.inf))
                    l_sum += p.sum(1)
                    d_sum += (p * dp).sum(1)
                ok = l_sum > 0  # a fully masked row keeps the forward's lse
                lse[bi, hi, i[ok]] += np.log(l_sum[ok])
                di[bi, hi, i[ok]] = d_sum[ok] / l_sum[ok]
                for j0 in range(0, kend, tile):  # pass 2
                    i, j, _, ds = p_ds(bi, hi, i0, j0)
                    dq[bi, hi, i] += ds @ k[bi, hi, j]
                    ds_sum[bi, hi, i] += ds.sum(1)
            for j0 in range(0, skv, tile):  # dk, dv: one block a key tile
                for i0 in range(0, sq, tile):
                    i_last = min(i0 + tile, sq) - 1
                    if not (lim[bi, i_last] > j0 or lim[bi, i0] == 0):
                        continue  # no row sees key j0 and none is fully masked
                    i, j, p, ds = p_ds(bi, hi, i0, j0)
                    dv[bi, hi, j] += p.T @ do[bi, hi, i]
                    dk[bi, hi, j] += ds.T @ q[bi, hi, i]
    return dq, dk, dv, ds_sum


_TF32 = np.uint32(0xFFFFE000)  # a TF32 value keeps the top 19 bits


def _tf32(x):
    """float32 -> TF32 by clearing the low 13 bits (the kernel's split
    truncates; ``test_torch_attention_tiles.py``'s ``tf32``)."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) & _TF32).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm3(a, b):
    """a @ b in 3xTF32 (lo*hi + hi*lo + hi*hi, each product exact in
    float64), rounded to float32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    f64 = lambda x, y: x.astype(np.float64) @ y.astype(np.float64)
    return (f64(al, bh) + f64(ah, bl) + f64(ah, bh)).astype(np.float32)


def _emulate_backward_3xtf32(q, k, v, do, lse, kv_len, causal, scale, di_from=None):
    """The tensor-core kernels' algorithm in numpy: every product in
    3xTF32; dq_kernel per 64 query rows over key tiles of 32 (64 at D=32),
    two walks (each row's own lse and Di, then dq = dS (K - k0) + (sum_j
    dS) k0); dkdv_kernel per 64 keys over the query tiles it keeps, S^T =
    K Q^T and dP^T = V dO^T, two warp groups taking the tiles in turns and
    adding their sums at the end.  With ``di_from`` = the forward's output o,
    the first walk is left out: P comes from the forward's lse and Di =
    rowsum(do * o).  Returns (dq, dk, dv, the rows' dS sums)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    rows, kt = 64, 64 if d == 32 else 32
    lim = _limits(b, sq, skv, causal, kv_len)
    lse = lse.copy()
    di = np.zeros_like(lse) if di_from is None else (do * di_from).sum(-1)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    ds_sum = np.zeros_like(lse)
    f32 = np.float32

    def p_ds(bi, hi, i, j, s, dp):
        """P and dS * scale of queries i x keys j from S and dP."""
        li = lim[bi, i][:, None]
        seen = j[None, :] < li
        p = np.exp(np.where(seen, s * f32(scale) - lse[bi, hi, i][:, None], -np.inf))
        p = np.where(li == 0, f32(1.0 / skv), p).astype(f32)
        ds = np.where(seen, p * (dp - di[bi, hi, i][:, None]) * f32(scale), 0.0)
        return p, ds.astype(f32)

    for bi in range(b):
        for hi in range(h):
            qh, kh, vh, dh = q[bi, hi], k[bi, hi], v[bi, hi], do[bi, hi]
            for i0 in range(0, sq, rows):  # dq_kernel
                i = np.arange(i0, min(i0 + rows, sq))
                kend = lim[bi, i[-1]]
                tiles = [np.arange(j0, min(j0 + kt, skv)) for j0 in range(0, kend, kt)]
                prods = [(j, _mm3(qh[i], kh[j].T), _mm3(dh[i], vh[j].T)) for j in tiles]
                if di_from is None:  # walk 1
                    l_sum, d_sum = np.zeros(len(i), f32), np.zeros(len(i), f32)
                    for j, s, dp in prods:
                        seen = j[None, :] < lim[bi, i][:, None]
                        p = np.exp(np.where(seen, s * f32(scale) - lse[bi, hi, i][:, None],
                                            -np.inf)).astype(f32)
                        l_sum += p.sum(1)
                        d_sum += (p * dp).sum(1)
                    ok = l_sum > 0  # a fully masked row keeps the forward's lse
                    lse[bi, hi, i[ok]] += np.log(l_sum[ok])
                    di[bi, hi, i[ok]] = d_sum[ok] / l_sum[ok]
                acc = np.zeros((len(i), d), f32)
                for j, s, dp in prods:  # walk 2
                    _, ds = p_ds(bi, hi, i, j, s, dp)
                    acc += _mm3(ds, kh[j] - kh[0])
                    ds_sum[bi, hi, i] += ds.sum(1)
                dq[bi, hi, i] = acc + ds_sum[bi, hi, i][:, None] * kh[0]
            for j0 in range(0, skv, rows):  # dkdv_kernel
                j = np.arange(j0, min(j0 + rows, skv))
                walked = [i0 for i0 in range(0, sq, kt)  # no row sees key j0, none fully masked
                          if lim[bi, min(i0 + kt, sq) - 1] > j0 or lim[bi, i0] == 0]
                sums = np.zeros((2, 2, len(j), d), f32)  # [warp group][dk, dv]
                for n, i0 in enumerate(walked):  # the two warp groups take turns
                    i = np.arange(i0, min(i0 + kt, sq))
                    p, ds = p_ds(bi, hi, i, j, _mm3(kh[j], qh[i].T).T, _mm3(vh[j], dh[i].T).T)
                    sums[n % 2, 0] += _mm3(ds.T, qh[i])
                    sums[n % 2, 1] += _mm3(p.T, dh[i])
                dk[bi, hi, j], dv[bi, hi, j] = sums[0] + sums[1]
    return dq, dk, dv, ds_sum


_EMULATIONS = {"fma32": _emulate_backward, "3xtf32": _emulate_backward_3xtf32}


@pytest.mark.parametrize("case,algorithm", [
    pytest.param(c, a, id=f"case{i}" + ("" if a == "fma32" else f"-{a}"))
    for a in _EMULATIONS for i, c in enumerate(CASES)])
def test_backward_algorithm_emulation_matches_jax(case, algorithm):
    """Both forms of the backward (float32 FMAs on 32-row tiles; the
    kernel's 3xTF32 products on 64-row blocks): with the forward's lse off
    by up to 1e-3 (the card's 3xTF32 logits are off by ~1e-6), the
    recomputed normaliser still gives the gradients, and every row of dS
    sums to 0 within float32 rounding."""
    b, h, sq, skv, d, causal, kv_len = case
    q, k, v, do = _inputs(b, h, sq, skv, d, sum(case[:5]))
    _, jgrads = _jax_grads(q, k, v, do, causal, kv_len)
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    _, lse = k2.flash_attention_lse(*(torch.from_numpy(a) for a in (q, k, v)), kvl, causal)
    off = np.random.default_rng(1).uniform(-1e-3, 1e-3, lse.shape).astype(np.float32)
    *got, ds_sum = _EMULATIONS[algorithm](q, k, v, do, lse.numpy() + off, kv_len, causal,
                                          1.0 / np.sqrt(d))
    for g, w in zip(got, jgrads):
        _close(g, w)
    assert np.abs(ds_sum).max() <= 1e-6 * np.abs(do).max() * np.abs(v).max()


def test_fully_masked_rows_give_q_and_k_nothing():
    """kv_len 0: the row averages v (dv gets do / Skv), q and k get 0."""
    q, k, v, do = _inputs(1, 1, 8, 8, 32, 3)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = k2.flash_attention(*leaves, kv_len=torch.tensor([0], dtype=torch.int32))
    out.backward(torch.from_numpy(do))
    assert float(leaves[0].grad.abs().max()) == 0.0 and float(leaves[1].grad.abs().max()) == 0.0
    np.testing.assert_allclose(leaves[2].grad.numpy()[0, 0],
                               np.broadcast_to(do[0, 0].sum(0) / 8, (8, 32)), rtol=1e-6)


def _forward_3xtf32(q, k, v, kv_len, scale):
    """(o, lse) as K2's float32 forward kernel computes them: 3xTF32
    logits scaled into the log2 domain, exp2, 3xTF32 P V, lse = (max +
    log2 l) ln 2."""
    o, lse = np.zeros_like(q), np.zeros(q.shape[:3], np.float32)
    for bi, hi in np.ndindex(q.shape[:2]):
        s = _mm3(q[bi, hi], k[bi, hi].T) * np.float32(scale * 1.4426950408889634)
        s[:, kv_len[bi]:] = np.float32(-1e30)
        m = s.max(1, keepdims=True)
        p = np.exp2(s - m).astype(np.float32)
        o[bi, hi] = _mm3(p, v[bi, hi]) / p.sum(1)[:, None]
        lse[bi, hi] = (m[:, 0] + np.log2(p.sum(1))) * np.float32(0.6931471805599453)
    return o, lse


def _dq_from_forward_stats(q, k, v, do, o, lse, kv_len, scale):
    """dq as a first design of the kernel took it (on the card its ranker
    gradients came out 4.2e-4 off the CPU's): S and dP in float32, P from
    the forward's lse, Di = rowsum(do * o)."""
    dq = np.zeros_like(q)
    for bi, hi in np.ndindex(q.shape[:2]):
        seen = np.arange(k.shape[2])[None, :] < kv_len[bi]
        s, dp = q[bi, hi] @ k[bi, hi].T, do[bi, hi] @ v[bi, hi].T
        p = np.where(seen, np.exp(s * np.float32(scale) - lse[bi, hi][:, None]), 0)
        di = (do[bi, hi] * o[bi, hi]).sum(1)
        dq[bi, hi] = (p * (dp - di[:, None]) * np.float32(scale)).astype(np.float32) @ k[bi, hi]
    return dq


@pytest.mark.parametrize("d", [32, 64])
def test_near_equal_keys_dq_holds_float32_precision(d):
    """Keys a shared key + 1e-3 noise (the reading-order ranker's
    geometry): dq = sum_j dS_ij k_j cancels down to the rounding of each
    row's sum of dS.  Against float64 autograd of the plain attention
    (relative RMS error over dq), the tensor-core emulation stays within
    twice the plain float32 gradient's own error; dq from the forward's
    statistics (P from its lse, Di = rowsum(do * o)) misses that bound."""
    rng = np.random.default_rng(0)
    b, h, s, kv_len = 2, 2, 128, [128, 90]
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = (rng.standard_normal((b, h, 1, d)) + 1e-3 * rng.standard_normal((b, h, s, d)))
    k = k.astype(np.float32)
    v, do = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(2))
    scale = 1.0 / np.sqrt(d)
    with torch.enable_grad():
        leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v)]
        logits = torch.einsum("bhqd,bhkd->bhqk", leaves[0], leaves[1]) * scale
        seen = torch.from_numpy(np.arange(s)[None, :] < np.asarray(kv_len)[:, None])
        probs = torch.softmax(torch.where(seen[:, None, None], logits, -1e30), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, leaves[2])
        want = torch.autograd.grad(out, leaves[0], torch.from_numpy(do).double())[0].numpy()
    plain = k2.attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v, do)), kv_len=torch.tensor(kv_len),
        sm_scale=scale)[0].numpy()
    rms = lambda a: np.sqrt(((a - want) ** 2).mean() / (want ** 2).mean())
    o, lse = _forward_3xtf32(q, k, v, kv_len, scale)
    tc = _emulate_backward_3xtf32(q, k, v, do, lse, kv_len, False, scale)[0]
    first = _dq_from_forward_stats(q, k, v, do, o, lse, kv_len, scale)
    assert 0 < rms(plain) < 1e-3
    assert rms(tc) <= 2 * rms(plain), (rms(tc), rms(plain))
    assert rms(first) > 2 * rms(plain), (rms(first), rms(plain))
