#!/usr/bin/env python3
"""Where the PyTorch port's ``best`` engine differs between the card and
the CPU, and what its TrOCR beam search costs on the card.

    python3 scripts/probe_best.py [--pages 4]

Run on a machine with a CUDA card, from the repository root.  Prints:

* for each of the first ``--pages`` shipped pages (``torch_zoo/``), the
  boxes of the registry's bf16 detector (``ocr/util.py::
  craft_box_processor``: heatmap CRAFT, batches of one page) on the card
  and on the CPU, and every box that differs; then the largest
  difference of the two heatmaps of page 0;
* for page 0's truth boxes, the registry's TrOCR beam-5 processor on the
  card: decode steps and wall ms of three calls (the first builds the
  kernels and cuDNN/cuBLAS plans), then a torch.profiler table of one
  more call with its kernel launches and device time.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def detection_differences(pages) -> None:
    import numpy as np

    from marie_tpu_torch.enums import PSMode
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.ocr.util import craft_box_processor, trocr_processor

    found, heat = {}, {}
    for dev in ("cuda", "cpu"):
        bp = craft_box_processor(device=dev)
        detected = PipelineOcrEngine(bp, trocr_processor(device=dev))._detect_pages(
            pages, PSMode.SPARSE)
        found[dev] = [(np.asarray(page[0]), np.asarray(page[2])) for _, page in detected]
        heat[dev] = bp.heatmap(pages[0]).float().cpu().numpy()
    for i, ((card, card_lines), (cpu, cpu_lines)) in enumerate(zip(found["cuda"], found["cpu"])):
        same_shape = card.shape == cpu.shape
        print(f"page {i}: {len(card)} / {len(cpu)} boxes (card / CPU), lines equal "
              f"{card_lines.shape == cpu_lines.shape and bool((card_lines == cpu_lines).all())}")
        if same_shape:
            for j in np.flatnonzero((card != cpu).any(axis=1)):
                print(f"  word {j}: card {card[j].tolist()} CPU {cpu[j].tolist()}")
    diff = np.abs(heat["cuda"] - heat["cpu"])
    print(f"page 0 heatmap: max |card - CPU| {diff.max():.6f}, share of pixels that differ "
          f"{(diff > 0).mean():.4f}")


def beam_cost(page, boxes) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import marie_tpu_torch.models.trocr as trocr
    from marie_tpu_torch.ocr.util import trocr_processor

    op = trocr_processor(beam_size=5, device="cuda")
    page = torch.from_numpy(page).cuda()
    steps = []
    step = trocr.TrOCRDecoder.step

    def counted(self, *args, **kwargs):
        steps.append(1)
        return step(self, *args, **kwargs)

    trocr.TrOCRDecoder.step = counted
    try:
        for _ in range(3):
            steps.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op.recognize_collect(op.recognize_dispatch(page, boxes))
            torch.cuda.synchronize()
            print(f"beam-5 page 0: {len(boxes)} boxes, {len(steps)} decode steps, "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    finally:
        trocr.TrOCRDecoder.step = step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        op.recognize_collect(op.recognize_dispatch(page, boxes))
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("marie.")]
    print(f"kernel launches {sum(e.count for e in kernels)}, device ms "
          f"{sum(e.self_device_time_total for e in kernels) / 1e3:.3f}")
    print(events.table(sort_by="self_cuda_time_total", row_limit=15))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pages", type=int, default=4)
    args = ap.parse_args()
    import json

    import numpy as np
    import torch

    from marie_tpu_torch.registry.zoo import ZOO_DIR
    from marie_tpu_torch.utils.device import card_name_and_power_limit

    if not torch.cuda.is_available():
        print("probe_best: no CUDA device", file=sys.stderr)
        return 2
    print(card_name_and_power_limit())
    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        pages = list(data["pages"][:args.pages])
    with open(os.path.join(ZOO_DIR, "truth.json")) as f:
        truth = json.load(f)["pages"][0]
    detection_differences(pages)
    beam_cost(pages[0], np.asarray([box for _, box in truth], np.float32))
    return 0


if __name__ == "__main__":
    sys.exit(main())
