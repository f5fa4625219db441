"""Time and trace one training step of a layout head, the CRNN or the overlay GAN on the card.

    python3 scripts/profile_train_step.py [--model splitter|base|crnn|overlay] [--tree DIR]
                                          [--cudnn-benchmark [--benchmark-limit N]]
                                          [--channels-last] [--prior-forward main|thread]

``splitter`` (the default): the splitter's model (``LayoutLMConfig.synth(2)``)
and 512 pages of its training set, batch 32.  ``base``: the classifier at
LayoutLMv3-base width (``LayoutLMConfig.base(3)``, S=512) and 64 pages of
its training set, batch 8, as ``chip_smoke.py``'s ``train`` phase (f).
``crnn``: ``train_crnn_device``'s step (``CRNNConfig()``, the
``crnn-synth`` width: a ResNet stack and two bidirectional LSTMs) on 512
rendered 32x256 crops, batch 128, as ``chip_smoke.py``'s ``ocr_train``
phase runs it; its JSON line adds the device share of the convolutions
(cuDNN's kernels, of which the FFT ones) and the convolutions' float32
bound.  ``overlay``: ``train_overlay_device``'s GAN step (``OverlayGan``: the synth
generator and the PatchGAN) on 32 rendered 512x384 pairs, batch 4; its
JSON line adds the convolutions' device share and float32 bound too (no
forward / backward split: the step is two optimisers' work).
``--channels-last`` runs the CRNN's convolutions in NHWC;
``--prior-forward`` runs the model once at the step's shape under
cuDNN's heuristics before the steps, on this thread or another (as
``chip_smoke.py``'s ``best`` phase runs the serving CRNN before
``ocr_train``).
``--cudnn-benchmark`` lets cuDNN time the first ``--benchmark-limit`` (by
default ``utils/device.py::CUDNN_BENCHMARK_LIMIT``) algorithms its
heuristics rank for each shape first, as ``train_crnn_device`` steps;
without it the heuristics' first choice runs.
Runs 20 warm-up steps of ``StepTrainer`` (5 at base width), then prints
the wall ms of a step, of the forward, of forward + backward and of the
AdamW step (each over 30 calls ending in a synchronise; 10 at base
width), torch.profiler's tables of 10 steps by host time and by device
time, and last one JSON line: the device ms a step and the share of it
in K2's gradient kernels (``dq_kernel`` and ``dkdv_kernel`` of
``csrc/flash_attention_bwd.cu``).  ``--tree`` runs another checkout's
``marie_tpu_torch`` (an earlier commit unpacked with ``git archive``), so
the share can be read before and after a change in one call.  The JSON
line also holds the first step's and the warm-up's seconds and the peak
of the memory allocated (MiB) over the warm-up (cuDNN's algorithm trials
included) and over the timed steps after it.
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
    ap.add_argument("--model", choices=("splitter", "base", "crnn", "overlay"),
                    default="splitter")
    ap.add_argument("--cudnn-benchmark", action="store_true",
                    help="let cuDNN time its algorithms for each shape")
    ap.add_argument("--benchmark-limit", type=int, default=None,
                    help="the algorithms cuDNN times a shape (default: the trainers')")
    ap.add_argument("--channels-last", action="store_true",
                    help="crnn: the convolutions' weights and activations in NHWC")
    ap.add_argument("--prior-forward", choices=("main", "thread"),
                    help="crnn: one forward at the step's shape under cuDNN's heuristics "
                         "first, on this thread or another")
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose marie_tpu_torch is run (default: this one)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from marie_tpu_torch.train import layout as tl
    from marie_tpu_torch.train.loop import StepTrainer, init_module
    from marie_tpu_torch.train.optim import warmup_cosine_decay_schedule
    from marie_tpu_torch.utils.device import card_name_and_power_limit, float32_precision

    if not os.path.abspath(tl.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"marie_tpu_torch came from {tl.__file__}, not {tree}")
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    if args.cudnn_benchmark:
        from marie_tpu_torch.utils.device import CUDNN_BENCHMARK_LIMIT

        limit = CUDNN_BENCHMARK_LIMIT if args.benchmark_limit is None else args.benchmark_limit
        torch.backends.cudnn.benchmark_limit = limit
    schedule = warmup_cosine_decay_schedule(0.0, 3e-4, 10, 100)
    gen = torch.Generator(device="cuda").manual_seed(1)
    conv_flops = None
    trainer = None
    if args.model == "overlay":
        n, batch, warm, reps = 32, 4, 10, 20
        step, draw, conv_flops = _overlay(n, batch, gen)
        seq_len = None
    elif args.model == "crnn":
        n, batch, warm, reps = 512, 128, 20, 30
        model, trainer, draw, conv_flops, seq_len = _crnn(n, batch, schedule, gen,
                                                          args.channels_last, args.prior_forward)
    else:
        from marie_tpu_torch.components.word_tokenizer import HashWordTokenizer
        from marie_tpu_torch.models.configs import LayoutLMConfig

        rng = np.random.default_rng(0)
        if args.model == "splitter":
            cfg = LayoutLMConfig.synth(2)
            n, batch, warm, reps = 512, 32, 20, 30
            data = tl.splitter_dataset(rng, n, HashWordTokenizer(cfg.vocab_size), cfg)
        else:
            cfg = LayoutLMConfig.base(len(tl.CLASS_POOLS))
            n, batch, warm, reps = 64, 8, 5, 10
            data = tl.classifier_dataset(rng, n, tl.CLASS_POOLS,
                                         HashWordTokenizer(cfg.vocab_size), cfg, False)
        seq_len = cfg.max_seq_len
        model = init_module(cfg, "sequence", 0, device="cuda")
        tensors = [torch.as_tensor(a, device="cuda") for a in data]
        trainer = StepTrainer(model, tl.head_loss(model, "sequence"), schedule, 0.01)

        def draw():
            idx = torch.randint(0, n, (batch,), generator=gen, device="cuda")
            return [t[idx] for t in tensors]

    if trainer is not None:
        def step():
            return trainer.step(*draw())

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(warm - 1):
        step()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    card = card_name_and_power_limit()
    print(card, flush=True)
    torch.cuda.reset_peak_memory_stats()
    step_ms = wall_ms(step)
    steady_mib = torch.cuda.max_memory_allocated() / 2**20
    print("step ms", step_ms)
    if trainer is not None:
        batch_t = draw()

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
    print(table.table(sort_by="self_cuda_time_total", row_limit=25))
    kernels = [e for e in table if str(getattr(e, "device_type", "")).endswith("CUDA")]
    kernels = kernels or list(table)  # no kernel rows: the ops' own device time
    device_us = sum(_device_us(e) for e in kernels)

    def share(words):
        us = sum(_device_us(e) for e in kernels if any(w in e.key.lower() for w in words))
        return us / steps / 1e3

    bwd_ms = share(("dq_kernel", "dkdv_kernel"))
    row = {"model": args.model, "tree": os.path.relpath(tree, ROOT), "card": card,
           "batch": batch, "seq_len": seq_len, "cudnn_benchmark": args.cudnn_benchmark,
           "benchmark_limit": torch.backends.cudnn.benchmark_limit if args.cudnn_benchmark
           else None,
           "channels_last": args.channels_last, "prior_forward": args.prior_forward,
           "first_step_s": first_s,
           "warmup_s": warm_s, "warmup_steps": warm,
           "step_ms": step_ms, "peak_mib": peak_mib, "steady_peak_mib": steady_mib,
           "device_ms_per_step": device_us / steps / 1e3,
           "k2_backward_ms_per_step": bwd_ms,
           "k2_backward_share": bwd_ms * steps * 1e3 / device_us if device_us else None}
    if conv_flops is not None:
        # cuDNN's convolution kernels (implicit GEMM, Winograd, FFT and the
        # weight-gradient reductions); the FFT ones by name
        row.update({"conv_ms_per_step": share(("conv", "fft", "winograd", "implicit_",
                                               "xmma", "wgrad", "dgrad", "flip_filter")),
                    "fft_ms_per_step": share(("fft",)),
                    "lstm_ms_per_step": share(("lstm", "rnn", "elemwise")),
                    "conv_gflop_per_step": conv_flops / 1e9,
                    "conv_fp32_bound_ms": conv_flops / FP32_FLOPS * 1e3})
    print(json.dumps(row))
    return 0


def run_prior_forward(model, images, where):
    """One forward of ``model`` on ``images`` with cuDNN's heuristics
    choosing (as a serving engine's CRNN runs at the trainer's shape
    before it in one process), on this thread or on another."""
    import threading

    import torch

    from marie_tpu_torch.utils.device import float32_precision

    def forward():
        with torch.no_grad(), float32_precision(False):
            model(images)
        torch.cuda.synchronize()

    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        if where == "thread":
            worker = threading.Thread(target=forward)
            worker.start()
            worker.join()
        else:
            forward()
    finally:
        torch.backends.cudnn.benchmark = saved


#: float32 outside the tensor cores, NVIDIA H100 SXM data sheet (chip_smoke.py's H100_FLOPS)
FP32_FLOPS = 67e12


def _conv_flops(model, *inputs) -> int:
    """The forward flops (2 per multiply-add) of every convolution and
    transposed convolution of ``model`` on ``inputs``."""
    import torch

    flops = 0

    def count(mod, inp, out):
        nonlocal flops
        if isinstance(mod, torch.nn.ConvTranspose2d):  # each input pixel into kh x kw x Cout
            flops += 2 * inp[0].numel() * mod.weight[0].numel()
        else:
            flops += 2 * out.numel() * mod.weight[0].numel()  # Cin * kh * kw an output

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with torch.no_grad():
        model(*inputs)
    for h in hooks:
        h.remove()
    return flops


def _overlay(n, batch, gen):
    """The overlay GAN's step: (step, draw, the convolutions' flops a step:
    three generator forwards' worth, and eight of the discriminator's (its
    step's two forwards and their gradients; the generator step's forward
    and its input gradient))."""
    import torch

    from marie_tpu_torch.models.configs import Pix2PixConfig
    from marie_tpu_torch.overlay.overlay import _unit_table
    from marie_tpu_torch.train import overlay as tov

    xs, ys = (torch.as_tensor(a, device="cuda") for a in tov.render_block(0, n, (512, 384)))
    g, d = tov.init_overlay(Pix2PixConfig.synth(), 0, device="cuda")
    gan = tov.OverlayGan(g, d)
    unit = _unit_table().cuda()

    def draw():
        idx = torch.randint(0, n, (batch,), generator=gen, device="cuda")
        return unit[xs[idx].long()], unit[ys[idx].long()]

    x, y = draw()
    flops = 3 * _conv_flops(g, x) + 8 * _conv_flops(d, torch.cat([x, y], -1))
    return (lambda: gan.step(*draw())), draw, flops


def _crnn(n, batch, schedule, gen, channels_last=False, prior_forward=None):
    """The CRNN trainer's step: (model, trainer, draw, the convolutions'
    flops a step, the column count)."""
    import torch

    from marie_tpu_torch.models.configs import CRNNConfig
    from marie_tpu_torch.models.tokenizer import CTCCharTokenizer
    from marie_tpu_torch.train import crnn as trn
    from marie_tpu_torch.train.loop import StepTrainer, init_module
    from marie_tpu_torch.train.recognizer import add_noise

    cfg, width = CRNNConfig(), 256
    imgs, labs, lens = (torch.as_tensor(a, device="cuda") for a in trn.render_crnn_block(
        trn._crnn_render_config(width, cfg.input_height), CTCCharTokenizer(), 0, n))
    model = init_module(cfg, None, 0, device="cuda").train()
    if channels_last:
        model.to(memory_format=torch.channels_last)
    trainer = StepTrainer(model, trn.crnn_loss(model), schedule, weight_decay=1e-4,
                          clip_norm=1.0, params=trn.crnn_trainable(model))
    if prior_forward:
        run_prior_forward(model, imgs[:batch].to(torch.float32) / 255.0, prior_forward)

    def draw():
        idx = torch.randint(0, n, (batch,), generator=gen, device="cuda")
        images = add_noise(imgs[idx].to(torch.float32) / 255.0, 0.03, gen, None, 0)
        return images, labs[idx], lens[idx]

    # a step's convolution flops are three times the forward's (forward,
    # data and weight gradients)
    return model, trainer, draw, 3 * _conv_flops(model, draw()[0]), width // 4


if __name__ == "__main__":
    raise SystemExit(main())
