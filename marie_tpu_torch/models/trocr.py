"""TrOCR recogniser (port of ``marie_tpu/models/trocr.py``): ViT encoder,
transformer decoder with prefilled cross K/V and per-layer self caches,
and :func:`greedy_decode`.

The JAX decode is a ``lax.while_loop`` in one compiled program; here it is
a Python loop that checks once per step whether every row is done."""

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from marie_tpu_torch.models.configs import DecoderConfig, TrOCRConfig
from marie_tpu_torch.models.layers import DecoderLayer, layer_norm, named_layers
from marie_tpu_torch.models.vit import ViTEncoder
from marie_tpu_torch.utils.device import float32_precision

KV = Tuple[torch.Tensor, torch.Tensor]


class TrOCRDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, enc_dim: int):
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.max_len, cfg.hidden_dim))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                cfg.num_heads, cfg.hidden_dim, cfg.mlp_dim, enc_dim,
                cross_kv_heads=cfg.cross_kv_heads))
        self.ln_f = layer_norm(cfg.hidden_dim)
        self.lm_head = nn.Linear(cfg.hidden_dim, cfg.vocab_size, bias=False)

    def layers(self) -> List[DecoderLayer]:
        return named_layers(self, self.cfg.num_layers)

    def prefill(self, enc: torch.Tensor) -> List[KV]:
        """Project encoder states to per-layer cross-attention K/V once."""
        return [layer.compute_cross_kv(enc) for layer in self.layers()]

    def step(self, token: torch.Tensor, pos: int, cross_kvs: List[KV],
             enc_len: Optional[torch.Tensor], self_caches: List[KV]):
        """One decode step -> logits [B, V]; ``self_caches`` are written
        in place at ``pos``."""
        x = self.token_embed(token)[:, None, :]
        x = x + self.pos_embed[:, pos:pos + 1].to(x.dtype)
        for layer, ckv, sc in zip(self.layers(), cross_kvs, self_caches):
            x = layer(x, ckv, enc_len, self_cache=sc, cache_index=pos)
        return self.lm_head(self.ln_f(x))[:, 0]


class TrOCRModel(nn.Module):
    def __init__(self, cfg: TrOCRConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = ViTEncoder(cfg.encoder)
        self.decoder = TrOCRDecoder(cfg.decoder, cfg.encoder.hidden_dim)
        self.eval()

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder(images)

    def prefill(self, enc: torch.Tensor) -> List[KV]:
        return self.decoder.prefill(enc)

    def decode_step(self, token, pos, cross_kvs, enc_len, self_caches):
        return self.decoder.step(token, pos, cross_kvs, enc_len, self_caches)


@torch.no_grad()
@float32_precision(allow_tf32=False)  # float32 matmuls as the JAX reference runs them
def greedy_decode(model: TrOCRModel, images: torch.Tensor,
                  max_steps: Optional[int] = None,
                  active: Optional[torch.Tensor] = None,
                  step_caps: Optional[torch.Tensor] = None):
    """Batched greedy decode of [B, H, W, C] crops.

    ``max_steps`` (<= decoder.max_len) bounds the decode, and the self
    caches are sized to it.  The loop exits once every row is done.
    ``active`` [B] bool: rows marked False start finished.  ``step_caps``
    [B] int: a row is force-finished after its own step budget.

    Returns (tokens [B, max_steps] int32 pad-filled after EOS, lengths [B]
    int32, confidences [B] float32 = exp(mean log-prob of the emitted
    tokens, EOS included))."""
    c = model.cfg.decoder
    dev = images.device
    b = images.shape[0]
    n_steps = min(max_steps or c.max_len, c.max_len)
    with record_function("marie.encode"):
        enc = model.encode(images)
        cross = model.prefill(enc)
    dh = c.hidden_dim // c.num_heads
    caches = [
        (torch.zeros(b, c.num_heads, n_steps, dh, dtype=enc.dtype, device=dev),
         torch.zeros(b, c.num_heads, n_steps, dh, dtype=enc.dtype, device=dev))
        for _ in range(c.num_layers)
    ]
    token = torch.full((b,), c.bos_id, dtype=torch.int64, device=dev)
    done = (torch.zeros(b, dtype=torch.bool, device=dev) if active is None
            else ~active.to(device=dev, dtype=torch.bool))
    caps = None if step_caps is None else step_caps.to(dev)
    toks = torch.full((b, n_steps), c.pad_id, dtype=torch.int32, device=dev)
    logp_sum = torch.zeros(b, dtype=torch.float32, device=dev)
    steps = torch.zeros(b, dtype=torch.int32, device=dev)
    pos = 0
    with record_function("marie.decode"):
        while pos < n_steps and not bool(done.all()):
            logits = model.decode_step(token, pos, cross, None, caches)
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            nxt = torch.argmax(logits, dim=-1)
            step_logp = logp.gather(1, nxt[:, None])[:, 0]
            nxt = torch.where(done, c.pad_id, nxt)
            logp_sum = logp_sum + torch.where(done, 0.0, step_logp)
            steps = steps + (~done).to(torch.int32)  # counts the EOS step
            is_eos = nxt == c.eos_id
            toks[:, pos] = torch.where(done | is_eos, c.pad_id, nxt).to(torch.int32)
            done = done | is_eos
            if caps is not None:
                done = done | (pos + 1 >= caps)
            token = nxt
            pos += 1
    emitted = (toks != c.pad_id).sum(dim=1).to(torch.int32)
    conf = torch.exp(logp_sum / torch.clamp(steps, min=1))
    return toks, emitted, conf.to(torch.float32)
