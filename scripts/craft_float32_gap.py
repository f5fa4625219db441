#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s two CRAFT training limits sit: the readings of
the sound trainer beside those of planted faults.

    python3 scripts/craft_float32_gap.py

(1) ``CRAFT_FLOAT32_GAP``: ``_craft_float32_gap`` (the float32 step's
gradients against the float64 step's, of each leaf's largest) on the
``ocr_train`` phase's batch (4 pages of 512x384, the ``craft-s2d2-synth``
tree) and on three more seeded batches on the card, on that batch on the
CPU, and on the card with each float32 fault planted: ``tf32`` (the step
under TF32, as a wrong precision setting would run it) and
``bf16_variance`` (the batch variance rounded to bfloat16 in float32, a
broken batch-statistics forward).

(2) ``CRAFT_TUNED_SLACK``: the phase's warm start (``OCR_WARM["craft"]``)
and the held-out loss of the fine-tuned tree over the zoo tree's on the
phase's 32 held-out pages, sound and with each running-statistics fault
planted: ``no_update`` (the running statistics never move),
``torch_momentum`` (momentum 0.1, ``nn.BatchNorm2d``'s, in place of
flax's 0.99) and ``torch_batchnorm`` (``nn.BatchNorm2d``'s own training
forward: its momentum and the unbiased variance).

The faults are planted by patching the port's functions in this process
only.  Prints one JSON line a reading, the card's name and power limit in
each.  Needs a CUDA device.
"""

import contextlib
import functools
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def planted(fault):
    """The port with ``fault`` planted (None: as it is)."""
    import torch

    from marie_tpu_torch.train import batchnorm
    from marie_tpu_torch.utils import device

    saved = {}

    def patch(mod, name, value):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, value)

    if fault == "tf32":
        patch(device, "float32_precision",
              lambda allow_tf32=False, orig=device.float32_precision: orig(True))
    elif fault == "bf16_variance":
        def forward(bn, x):
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            if x.dtype == torch.float32:
                var = var.to(torch.bfloat16).to(x.dtype)
            bn.flax_batch_stats = (mean.detach(), var.detach())
            return batchnorm._normalize(bn, x, mean, var)

        patch(batchnorm, "_batch_forward", forward)
    elif fault == "no_update":
        patch(batchnorm, "update_running_statistics", lambda model, momentum=None: None)
    elif fault == "torch_momentum":
        patch(batchnorm, "update_running_statistics",
              functools.partial(batchnorm.update_running_statistics, momentum=0.1))
    elif fault == "torch_batchnorm":
        patch(batchnorm, "use_batch_statistics", lambda model: None)
        patch(batchnorm, "update_running_statistics", lambda model, momentum=None: None)
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for (mod, name), value in saved.items():
            setattr(mod, name, value)


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from marie_tpu_torch.models.configs import CraftConfig
    from marie_tpu_torch.registry.zoo import zoo_params
    from marie_tpu_torch.train import craft as tcr
    from marie_tpu_torch.train.loop import init_module
    from marie_tpu_torch.utils.device import card_name_and_power_limit

    cs = _smoke()
    card = card_name_and_power_limit()
    cfg = CraftConfig.fast_s2d2()
    tree = zoo_params(cs.OCR_TREES["craft"])

    def batch(seed):
        pages, targets = tcr.render_pages(np.random.default_rng(seed), cs.OCR_STEP_BATCH["craft"],
                                          cs.CRAFT_PAGE_HW, cfg.out_stride)
        return pages.astype(np.float32) / 255.0, targets.astype(np.float32) / 255.0

    def emit(row):
        print(json.dumps({"card": card, **row}), flush=True)

    phase_batch = batch(cs.TRAIN_SEED + 91)
    for seed in range(cs.TRAIN_SEED + 91, cs.TRAIN_SEED + 95):
        emit({"part": "gap", "fault": None, "device": "cuda", "batch_seed": seed,
              "gap": cs._craft_float32_gap(cfg, tree, batch(seed) if seed != cs.TRAIN_SEED + 91
                                           else phase_batch)})
    emit({"part": "gap", "fault": None, "device": "cpu", "batch_seed": cs.TRAIN_SEED + 91,
          "gap": cs._craft_float32_gap(cfg, tree, phase_batch, device="cpu")})
    for fault in ("tf32", "bf16_variance"):
        with planted(fault):
            emit({"part": "gap", "fault": fault, "device": "cuda",
                  "batch_seed": cs.TRAIN_SEED + 91,
                  "gap": cs._craft_float32_gap(cfg, tree, phase_batch)})

    h_pages, h_targets = tcr.render_pages(np.random.default_rng(cs.OCR_HELDOUT_SEED),
                                          cs.CRAFT_EVAL_PAGES, cs.CRAFT_PAGE_HW, cfg.out_stride)
    model = init_module(cfg, None, 0, tree, "cuda").eval()
    zoo_loss = tcr.craft_heldout_loss(model, h_pages, h_targets)
    del model
    for fault in (None, "no_update", "torch_momentum", "torch_batchnorm"):
        t0 = time.perf_counter()
        with planted(fault):
            model, _ = tcr.train_craft_device(
                config=cfg, batch_size=cs.OCR_STEP_BATCH["craft"], page_hw=cs.CRAFT_PAGE_HW,
                steps_per_dispatch=25, refresh_every=0, seed=cs.TRAIN_SEED,
                init_params=tree, device="cuda", **cs.OCR_WARM["craft"])
        loss = tcr.craft_heldout_loss(model, h_pages, h_targets)
        del model
        torch.cuda.empty_cache()
        emit({"part": "tuned", "fault": fault, "zoo_loss": zoo_loss, "tuned_loss": loss,
              "over_zoo": loss / zoo_loss - 1.0, "wall_s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
