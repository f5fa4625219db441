"""Time and trace one training step of the splitter on the card.

    python3 scripts/profile_train_step.py

Builds the splitter's model (``LayoutLMConfig.synth(2)``) and 512 pages of
its training set, runs 20 warm-up steps of ``StepTrainer`` (batch 32),
then prints the wall ms of a step, of the forward, of forward + backward
and of the AdamW step (each over 30 calls ending in a synchronise), and
torch.profiler's tables of 10 steps by host time and by device time.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from marie_tpu_torch.components.word_tokenizer import HashWordTokenizer
    from marie_tpu_torch.models.configs import LayoutLMConfig
    from marie_tpu_torch.train import layout as tl
    from marie_tpu_torch.train.loop import StepTrainer, init_module
    from marie_tpu_torch.train.optim import warmup_cosine_decay_schedule
    from marie_tpu_torch.utils.device import card_name_and_power_limit, float32_precision

    cfg = LayoutLMConfig.synth(2)
    data = tl.splitter_dataset(np.random.default_rng(0), 512,
                               HashWordTokenizer(cfg.vocab_size), cfg)
    model = init_module(cfg, "sequence", 0, device="cuda")
    toks, bxs, lens, ys = (torch.as_tensor(a, device="cuda") for a in data)
    trainer = StepTrainer(model, tl.head_loss(model, "sequence"),
                          warmup_cosine_decay_schedule(0.0, 3e-4, 10, 100), 0.01)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def step():
        idx = torch.randint(0, 512, (32,), generator=gen, device="cuda")
        return trainer.step(toks[idx], bxs[idx], lens[idx], ys[idx])

    def wall_ms(fn, n=30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    for _ in range(20):
        step()
    print(card_name_and_power_limit(), flush=True)
    print("step ms", wall_ms(step))
    idx = torch.randint(0, 512, (32,), generator=gen, device="cuda")
    batch = (toks[idx], bxs[idx], lens[idx], ys[idx])

    def forward():
        with torch.no_grad(), float32_precision(False):
            trainer.loss_fn(*batch)

    def forward_backward():
        trainer.opt.zero_grad()
        with float32_precision(False):
            trainer.loss_fn(*batch).backward()

    print("forward ms", wall_ms(forward), "forward+backward ms", wall_ms(forward_backward),
          "AdamW ms", wall_ms(trainer.opt.step))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step()
        torch.cuda.synchronize()
    table = prof.key_averages()
    print(table.table(sort_by="self_cpu_time_total", row_limit=25))
    print(table.table(sort_by="self_cuda_time_total", row_limit=15))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
