"""Time and trace one training step of a layout head on the card.

    python3 scripts/profile_train_step.py [--model splitter|base] [--tree DIR]

``splitter`` (the default): the splitter's model (``LayoutLMConfig.synth(2)``)
and 512 pages of its training set, batch 32.  ``base``: the classifier at
LayoutLMv3-base width (``LayoutLMConfig.base(3)``, S=512) and 64 pages of
its training set, batch 8, as ``chip_smoke.py``'s ``train`` phase (f).
Runs 20 warm-up steps of ``StepTrainer`` (5 at base width), then prints
the wall ms of a step, of the forward, of forward + backward and of the
AdamW step (each over 30 calls ending in a synchronise; 10 at base
width), torch.profiler's tables of 10 steps by host time and by device
time, and last one JSON line: the device ms a step and the share of it
in K2's gradient kernels (``dq_kernel`` and ``dkdv_kernel`` of
``csrc/flash_attention_bwd.cu``).  ``--tree`` runs another checkout's
``marie_tpu_torch`` (an earlier commit unpacked with ``git archive``), so
the share can be read before and after a change in one call.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_us(evt) -> float:
    """An event's own device time in us (the attribute's name moved between
    torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("splitter", "base"), default="splitter")
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose marie_tpu_torch is run (default: this one)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from marie_tpu_torch.components.word_tokenizer import HashWordTokenizer
    from marie_tpu_torch.models.configs import LayoutLMConfig
    from marie_tpu_torch.train import layout as tl
    from marie_tpu_torch.train.loop import StepTrainer, init_module
    from marie_tpu_torch.train.optim import warmup_cosine_decay_schedule
    from marie_tpu_torch.utils.device import card_name_and_power_limit, float32_precision

    if not os.path.abspath(tl.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"marie_tpu_torch came from {tl.__file__}, not {tree}")
    rng = np.random.default_rng(0)
    if args.model == "splitter":
        cfg = LayoutLMConfig.synth(2)
        n, batch, warm, reps = 512, 32, 20, 30
        data = tl.splitter_dataset(rng, n, HashWordTokenizer(cfg.vocab_size), cfg)
    else:
        cfg = LayoutLMConfig.base(len(tl.CLASS_POOLS))
        n, batch, warm, reps = 64, 8, 5, 10
        data = tl.classifier_dataset(rng, n, tl.CLASS_POOLS, HashWordTokenizer(cfg.vocab_size),
                                     cfg, False)
    model = init_module(cfg, "sequence", 0, device="cuda")
    toks, bxs, lens, ys = (torch.as_tensor(a, device="cuda") for a in data)
    trainer = StepTrainer(model, tl.head_loss(model, "sequence"),
                          warmup_cosine_decay_schedule(0.0, 3e-4, 10, 100), 0.01)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def step():
        idx = torch.randint(0, n, (batch,), generator=gen, device="cuda")
        return trainer.step(toks[idx], bxs[idx], lens[idx], ys[idx])

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    for _ in range(warm):
        step()
    card = card_name_and_power_limit()
    print(card, flush=True)
    step_ms = wall_ms(step)
    print("step ms", step_ms)
    idx = torch.randint(0, n, (batch,), generator=gen, device="cuda")
    batch_t = (toks[idx], bxs[idx], lens[idx], ys[idx])

    def forward():
        with torch.no_grad(), float32_precision(False):
            trainer.loss_fn(*batch_t)

    def forward_backward():
        trainer.opt.zero_grad()
        with float32_precision(False):
            trainer.loss_fn(*batch_t).backward()

    print("forward ms", wall_ms(forward), "forward+backward ms", wall_ms(forward_backward),
          "AdamW ms", wall_ms(trainer.opt.step))
    steps = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    table = prof.key_averages()
    print(table.table(sort_by="self_cpu_time_total", row_limit=25))
    print(table.table(sort_by="self_cuda_time_total", row_limit=15))
    kernels = [e for e in table if str(getattr(e, "device_type", "")).endswith("CUDA")]
    kernels = kernels or list(table)  # no kernel rows: the ops' own device time
    device_us = sum(_device_us(e) for e in kernels)
    bwd_us = sum(_device_us(e) for e in kernels if "dq_kernel" in e.key or "dkdv_kernel" in e.key)
    print(json.dumps({"model": args.model, "tree": os.path.relpath(tree, ROOT), "card": card,
                      "batch": batch, "seq_len": cfg.max_seq_len, "step_ms": step_ms,
                      "device_ms_per_step": device_us / steps / 1e3,
                      "k2_backward_ms_per_step": bwd_us / steps / 1e3,
                      "k2_backward_share": bwd_us / device_us if device_us else None}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
