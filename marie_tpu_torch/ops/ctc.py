"""Greedy CTC decoding (port of ``marie_tpu/ops/ctc.py``): the collapse
runs on the device with static shapes; the token ids turn into text on
the host.  Stock ops: the JAX version is XLA, not a Pallas kernel."""

from typing import Tuple

import torch


def ctc_greedy_decode(logits: torch.Tensor, blank_id: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy CTC decode of per-frame scores ``logits`` [B, T, V].

    Returns (tokens [B, T] int32: the decoded ids, repeats collapsed and
    blanks dropped, left-aligned and padded with -1; lengths [B] int32:
    the number of emitted ids; confidence [B] float32: the mean max-prob
    over the non-blank frames)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    best = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, T]
    best_p = probs.amax(dim=-1)
    b, t = best.shape
    prev = torch.cat([torch.full((b, 1), -1, dtype=torch.int32, device=best.device),
                      best[:, :-1]], dim=1)
    emit = (best != blank_id) & (best != prev)  # collapse repeats, drop blanks
    pos = torch.cumsum(emit.to(torch.int32), dim=1) - 1  # emission slot
    # frames that emit nothing write to a spare column t, cut off below
    write_pos = torch.where(emit, pos, t).to(torch.int64)
    tokens = torch.full((b, t + 1), -1, dtype=torch.int32, device=best.device)
    tokens.scatter_(1, write_pos, torch.where(emit, best, -1))
    lengths = emit.sum(dim=1).to(torch.int32)
    nb = best != blank_id
    conf = (torch.where(nb, best_p, 0.0).sum(dim=1)
            / torch.clamp(nb.sum(dim=1), min=1).to(torch.float32))
    return tokens[:, :t], lengths, conf.to(torch.float32)
