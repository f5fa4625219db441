#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s NEW_FLOAT32_GAP limits sit: the float32
card step of the boundary, DiT and TextFuseNet trainers against their
float64 card step, sound and with planted faults.

    python3 scripts/trainer_float32_gap.py [--kinds boundary dit textfusenet]

For each trainer, ``_new_trainer_float32_gap`` (every gradient leaf's
largest departure from float64, of that leaf's largest) on the
``ocr_train`` phase's batch and three more seeded batches (the trees and
shapes of ``_new_trainer_batches``), then on the phase's batch with each
float32 fault planted: ``tf32`` (the step under TF32, as a wrong
precision setting would run it) and ``bf16_stat`` (the normalisation's
variance rounded to bfloat16 in float32: the GroupNorms of the boundary
regressor and of TextFuseNet's fuse module, DiT's LayerNorms, TextFuseNet's
BatchNorm running variances).  Each reading gives
the gated gap (``_gated_gap``), the worst and the median leaf and the
loss's relative departure.

The faults are planted by patching the port's functions in this process
only.  Prints one JSON line a reading, the card's name and power limit in
each.  Needs a CUDA device.
"""

import argparse
import contextlib
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("boundary", "dit", "textfusenet")
BATCHES = 4


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def planted(fault):
    """The port with ``fault`` planted (None: as it is)."""
    import torch
    import torch.nn as nn

    from marie_tpu_torch.models import pix2pix
    from marie_tpu_torch.train import batchnorm
    from marie_tpu_torch.utils import device

    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def bf16(t):
        return t.to(torch.bfloat16).to(t.dtype) if t.dtype == torch.float32 else t

    if fault == "tf32":
        patch(device, "float32_precision",
              lambda allow_tf32=False, orig=device.float32_precision: orig(True))
    elif fault == "bf16_stat":
        def group_norm(gn, x):
            b, c, h, w = x.shape
            g = gn.groups or c
            grouped = x.reshape(b, g, c // g, h, w)
            mean = grouped.mean(dim=(2, 3, 4), keepdim=True)
            var = bf16(torch.clamp((grouped * grouped).mean(dim=(2, 3, 4), keepdim=True)
                                   - mean * mean, min=0.0))
            y = ((grouped - mean) * torch.rsqrt(var + pix2pix.GN_EPS)).reshape(b, c, h, w)
            return y * gn.weight[None, :, None, None] + gn.bias[None, :, None, None]

        def layer_norm(ln, x):
            mean = x.mean(dim=-1, keepdim=True)
            var = bf16(((x - mean) ** 2).mean(dim=-1, keepdim=True))
            return (x - mean) * torch.rsqrt(var + ln.eps) * ln.weight + ln.bias

        def running(bn, x):
            return batchnorm._normalize(bn, x, bn.running_mean, bf16(bn.running_var))

        patch(pix2pix.GroupNorm, "forward", group_norm)
        patch(nn.LayerNorm, "forward", layer_norm)
        patch(batchnorm, "_running_forward", running)
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kinds", nargs="+", default=list(KINDS), choices=KINDS)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from marie_tpu_torch.utils.device import card_name_and_power_limit

    cs = _smoke()
    card = card_name_and_power_limit()

    def reading(kind, cfg, tree, data, **row):
        got = cs._new_trainer_float32_gap(kind, cfg, tree, data)
        gaps = got["gaps"]
        print(json.dumps({"card": card, "model": kind, **row,
                          "gated": cs._gated_gap(kind, gaps), "worst": gaps[0],
                          "median": gaps[len(gaps) // 2][0],
                          "loss_rel_err": got["loss_rel_err"],
                          "limit": cs.NEW_FLOAT32_GAP[kind]}), flush=True)
        torch.cuda.empty_cache()

    batches = [cs._new_trainer_batches(cs.TRAIN_SEED + 91 + 2 * i) for i in range(BATCHES)]
    for kind in args.kinds:
        for i, by_kind in enumerate(batches):
            reading(kind, *by_kind[kind], fault=None, batch_seed=cs.TRAIN_SEED + 91 + 2 * i)
        for fault in ("tf32", "bf16_stat"):
            with planted(fault):
                reading(kind, *batches[0][kind], fault=fault, batch_seed=cs.TRAIN_SEED + 91)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
