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
* A numpy emulation of the CUDA backward's tiled algorithm
  (``csrc/flash_attention_bwd.cu``: each row's normaliser and Di
  recomputed from its own S under the forward's lse, P and dS from them, a
  fully masked row's P 1/Skv and dS 0, the query tiles the dk/dv pass
  skips, the key tiles the dq pass walks) against the same gradients: the
  kernel cannot run here, its arithmetic can.
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


@pytest.mark.parametrize("case", CASES)
def test_backward_algorithm_emulation_matches_jax(case):
    """With the forward's lse off by up to 1e-3 (the card's 3xTF32 logits
    are off by ~1e-6), the recomputed normaliser still gives the
    gradients, and every row of dS sums to 0 within float32 rounding."""
    b, h, sq, skv, d, causal, kv_len = case
    q, k, v, do = _inputs(b, h, sq, skv, d, sum(case[:5]))
    _, jgrads = _jax_grads(q, k, v, do, causal, kv_len)
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    _, lse = k2.flash_attention_lse(*(torch.from_numpy(a) for a in (q, k, v)), kvl, causal)
    off = np.random.default_rng(1).uniform(-1e-3, 1e-3, lse.shape).astype(np.float32)
    *got, ds_sum = _emulate_backward(q, k, v, do, lse.numpy() + off, kv_len, causal,
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
