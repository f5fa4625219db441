"""Transformer building blocks (port of ``marie_tpu/models/layers.py``).

Module and attribute names follow the flax modules (``q``, ``kv.k``,
``kv.v``, ``out``, ``ln1``, ``mlp.fc1`` ...) so the weight bridge
(:mod:`marie_tpu_torch.registry.convert`) maps a flax path to a torch
key by name.  Two flax defaults are kept: ``nn.gelu`` is the tanh
approximation and ``nn.LayerNorm`` uses eps 1e-6.

Full-sequence self-attention goes through the fused attention kernel
(:func:`marie_tpu_torch.ops.kernels.flash_attention.flash_attention`);
the cached decode step and cross-attention use the plain
:func:`_masked_attention`, as the JAX package does.
"""

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from marie_tpu_torch.ops.kernels.flash_attention import flash_attention

KV = Tuple[torch.Tensor, torch.Tensor]  # ([B,H,L,Dh], [B,H,L,Dh])

_NEG_INF = -1e30
LN_EPS = 1e-6


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def dense_general(in_dim: int, num_heads: int, head_dim: int) -> nn.Linear:
    """flax ``DenseGeneral((H, dh))``: kernel [in, H, dh] -> Linear
    [H*dh, in]; the flax shapes ride along for the weight bridge."""
    lin = nn.Linear(in_dim, num_heads * head_dim)
    lin.flax_shapes = {"kernel": (in_dim, num_heads, head_dim),
                       "bias": (num_heads, head_dim)}
    return lin


def dense_general_out(num_heads: int, head_dim: int, out_dim: int) -> nn.Linear:
    """flax ``DenseGeneral(out, axis=(-2, -1))``: kernel [H, dh, out] ->
    Linear [out, H*dh]."""
    lin = nn.Linear(num_heads * head_dim, out_dim)
    lin.flax_shapes = {"kernel": (num_heads, head_dim, out_dim),
                       "bias": (out_dim,)}
    return lin


def _split(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, _ = x.shape
    return x.view(b, l, num_heads, -1).transpose(1, 2)  # [B,H,L,dh]


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def _masked_attention(q, k, v, mask: Optional[torch.Tensor]):
    """Plain attention for short query lengths (decode steps).
    q [B,H,Lq,Dh]; k/v carry G <= H heads (grouped-query when G < H)."""
    dh = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=q.dtype, device=q.device))
    h, g = q.shape[1], k.shape[1]
    if g == h:
        logits = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
        if mask is not None:
            logits = torch.where(mask, logits, _NEG_INF)
        probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v)
    b, _, lq, _ = q.shape
    qg = q.reshape(b, g, h // g, lq, dh)
    logits = torch.einsum("bgmqd,bgkd->bgmqk", qg * scale, k)
    if mask is not None:
        logits = torch.where(mask[:, :, None], logits, _NEG_INF)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    out = torch.einsum("bgmqk,bgkd->bgmqd", probs, v)
    return out.reshape(b, h, lq, dh)


class KVProjection(nn.Module):
    def __init__(self, in_dim: int, num_heads: int, head_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.k = dense_general(in_dim, num_heads, head_dim)
        self.v = dense_general(in_dim, num_heads, head_dim)

    def forward(self, x_kv: torch.Tensor) -> KV:
        return _split(self.k(x_kv), self.num_heads), _split(self.v(x_kv), self.num_heads)


class SelfAttention(nn.Module):
    """Self-attention with optional causal masking and a decode cache."""

    def __init__(self, num_heads: int, model_dim: int):
        super().__init__()
        dh = model_dim // num_heads
        self.num_heads = num_heads
        self.q = dense_general(model_dim, num_heads, dh)
        self.kv = KVProjection(model_dim, num_heads, dh)
        self.out = dense_general_out(num_heads, dh, model_dim)

    def forward(self, x, *, causal: bool = False,
                kv_len: Optional[torch.Tensor] = None,
                cache: Optional[KV] = None, cache_index: Optional[int] = None):
        q = _split(self.q(x), self.num_heads)
        k, v = self.kv(x)
        if cache is not None:
            # the caller-owned cache is written in place (the JAX version
            # returns an updated copy); positions > cache_index are masked
            ck, cv = cache
            lq = k.shape[2]
            ck[:, :, cache_index:cache_index + lq] = k
            cv[:, :, cache_index:cache_index + lq] = v
            pos = torch.arange(ck.shape[2], device=x.device)
            mask = (pos <= cache_index)[None, None, None, :]
            out = _masked_attention(q, ck, cv, mask)
        else:
            out = flash_attention(q, k, v, kv_len=kv_len, causal=causal)
        return self.out(_merge(out))


class CrossAttention(nn.Module):
    """Cross-attention over K/V projected once per sequence (prefill)."""

    def __init__(self, num_heads: int, model_dim: int):
        super().__init__()
        dh = model_dim // num_heads
        self.num_heads = num_heads
        self.q = dense_general(model_dim, num_heads, dh)
        self.out = dense_general_out(num_heads, dh, model_dim)

    def forward(self, x, kv: KV, kv_len: Optional[torch.Tensor] = None):
        q = _split(self.q(x), self.num_heads)
        k, v = kv
        mask = None
        if kv_len is not None:
            pos = torch.arange(k.shape[2], device=x.device)
            mask = pos[None, None, None, :] < kv_len[:, None, None, None]
        return self.out(_merge(_masked_attention(q, k, v, mask)))


class MlpBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, out_dim: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, out_dim or dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class EncoderLayer(nn.Module):
    def __init__(self, num_heads: int, model_dim: int, mlp_dim: int):
        super().__init__()
        self.ln1 = layer_norm(model_dim)
        self.attn = SelfAttention(num_heads, model_dim)
        self.ln2 = layer_norm(model_dim)
        self.mlp = MlpBlock(model_dim, mlp_dim)

    def forward(self, x, kv_len: Optional[torch.Tensor] = None):
        x = x + self.attn(self.ln1(x), kv_len=kv_len)
        return x + self.mlp(self.ln2(x))


class DecoderLayer(nn.Module):
    """Pre-LN decoder layer: causal self-attn -> cross-attn -> MLP, with
    ``cross_kv_heads`` (G < H: grouped-query) cross K/V heads of the
    per-head width model_dim // num_heads."""

    def __init__(self, num_heads: int, model_dim: int, mlp_dim: int,
                 enc_dim: int, cross_kv_heads: Optional[int] = None):
        super().__init__()
        dh = model_dim // num_heads
        self.ln1 = layer_norm(model_dim)
        self.self_attn = SelfAttention(num_heads, model_dim)
        self.ln2 = layer_norm(model_dim)
        self.cross_kv = KVProjection(enc_dim, cross_kv_heads or num_heads, dh)
        self.cross_attn = CrossAttention(num_heads, model_dim)
        self.ln3 = layer_norm(model_dim)
        self.mlp = MlpBlock(model_dim, mlp_dim)

    def compute_cross_kv(self, enc: torch.Tensor) -> KV:
        return self.cross_kv(enc)

    def forward(self, x, cross: KV, enc_len=None, self_cache: Optional[KV] = None,
                cache_index: Optional[int] = None):
        x = x + self.self_attn(self.ln1(x), causal=self_cache is None,
                               cache=self_cache, cache_index=cache_index)
        x = x + self.cross_attn(self.ln2(x), cross, kv_len=enc_len)
        return x + self.mlp(self.ln3(x))


def sinusoidal_positions(length: int, dim: int, dtype=torch.float32) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0), 2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def named_layers(module: nn.Module, count: int) -> List[nn.Module]:
    """``layer_0 .. layer_{count-1}`` children, in order."""
    return [getattr(module, f"layer_{i}") for i in range(count)]
