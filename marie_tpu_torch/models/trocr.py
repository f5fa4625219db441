"""TrOCR recogniser (port of ``marie_tpu/models/trocr.py``): ViT encoder,
transformer decoder with prefilled cross K/V and per-layer self caches,
:func:`greedy_decode` and :func:`beam_decode`.

Each JAX decode is a ``lax.while_loop`` in one compiled program; here
each is a Python loop that checks once per step whether every row is
done."""

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


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of each row of
    ``x``, in descending order, equal values by ascending index, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order among
    equal values)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.no_grad()
@float32_precision(allow_tf32=False)
def beam_decode(model: TrOCRModel, images: torch.Tensor, beam_size: int = 5,
                len_penalty: float = 1.0):
    """Batched beam search of [B, H, W, C] crops with fairseq's semantics
    (length-normalised scores), to ``decoder.max_len`` steps.

    Only beam 0 is live at the start; a finished beam may emit only PAD,
    its score unchanged; each step keeps the best ``beam_size`` of the
    beams' candidates (ties to the lower beam, then token) and carries the
    tokens, lengths and self caches with them.  The loop exits once every
    beam of every row has emitted EOS.

    Returns (tokens [B, max_len] int32: the best hypothesis, pad-filled,
    lengths [B] int32, confidences [B] float32 = exp(score / (length +
    1) ** len_penalty))."""
    c = model.cfg.decoder
    dev = images.device
    b, k, v = images.shape[0], beam_size, c.vocab_size
    with record_function("marie.encode"):
        enc = model.encode(images)
        # tiled to the beams: row r's beams are rows r*k .. r*k + k-1
        cross = [(ck.repeat_interleave(k, 0), cv.repeat_interleave(k, 0))
                 for ck, cv in model.prefill(enc)]
    dh = c.hidden_dim // c.num_heads
    caches = [
        (torch.zeros(b * k, c.num_heads, c.max_len, dh, dtype=enc.dtype, device=dev),
         torch.zeros(b * k, c.num_heads, c.max_len, dh, dtype=enc.dtype, device=dev))
        for _ in range(c.num_layers)
    ]
    tokens = torch.full((b, k, c.max_len), c.pad_id, dtype=torch.int32, device=dev)
    cur = torch.full((b * k,), c.bos_id, dtype=torch.int64, device=dev)
    scores = torch.full((b, k), -1e30, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    fin = torch.zeros(b, k, dtype=torch.bool, device=dev)
    lens = torch.zeros(b, k, dtype=torch.int32, device=dev)
    pad_row = torch.full((v,), -1e30, dtype=torch.float32, device=dev)
    pad_row[c.pad_id] = 0.0
    first_beam = torch.arange(b, device=dev)[:, None] * k
    pos = 0
    with record_function("marie.decode"):
        while pos < c.max_len and not bool(fin.all()):
            logits = model.decode_step(cur, pos, cross, None, caches)
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1).view(b, k, v)
            logp = torch.where(fin[:, :, None], pad_row, logp)
            new_scores, idx = _top_k((scores[:, :, None] + logp).view(b, k * v), k)
            beam_idx = idx // v
            tok = idx % v
            tokens = tokens.gather(1, beam_idx[:, :, None].expand(b, k, c.max_len))
            fin = fin.gather(1, beam_idx)
            lens = lens.gather(1, beam_idx)
            rows = (first_beam + beam_idx).view(-1)
            caches = [(ck.index_select(0, rows), cv.index_select(0, rows)) for ck, cv in caches]
            is_eos = tok == c.eos_id
            tokens[:, :, pos] = torch.where(fin | is_eos, c.pad_id, tok).to(torch.int32)
            lens = torch.where(fin, lens, lens + (~is_eos).to(torch.int32))
            fin = fin | is_eos
            scores = new_scores
            cur = tok.view(-1)
            pos += 1
    final = scores / torch.clamp(lens + 1, min=1).to(torch.float32) ** len_penalty
    best = torch.argmax(final, dim=1)  # the first maximum, as jnp.argmax
    pick = torch.arange(b, device=dev)
    return (tokens[pick, best], lens[pick, best],
            torch.exp(final[pick, best]).to(torch.float32))
