#!/usr/bin/env python3
"""Host cost of the port's bf16 CRAFT forward by thread.

    python3 scripts/detector_thread_cost.py

Builds ``chip_smoke.py``'s serving detector (CRAFT fast_s2d2 in bf16,
seeded weights) on the card and times ``craft_heatmap`` on 16 pages of
1024x768: four calls on the main thread, one call in each of four fresh
threads, and four calls in one other thread.  cuDNN keeps its
convolution plans per thread, so the first call in a thread pays for
building them.  Prints one JSON line per series (host ms to enqueue,
and to the end of the device work) and the card's name and power limit.
"""

import json
import os
import sys
import threading
import time


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("detector_thread_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from marie_tpu_torch.boxes.craft_box_processor import craft_heatmap
    from marie_tpu_torch.models.configs import CraftConfig
    from marie_tpu_torch.registry.convert import init_flax_layout
    from marie_tpu_torch.utils.device import card_name_and_power_limit

    pages = chip_smoke.draw_pages(16, 1024, 768, chip_smoke.SEED + 3)
    bp = chip_smoke.serving_detector(
        "heatmap", pages, init_flax_layout(CraftConfig.fast_s2d2(), chip_smoke.SEED))
    x = torch.from_numpy(pages).cuda()

    def once(out):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        craft_heatmap(bp.model, x)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out.append([(t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3])

    def in_thread(fn, *args):
        t = threading.Thread(target=fn, args=args)
        t.start()
        t.join()

    series = {"main_thread": [], "fresh_thread_each_call": [], "one_other_thread": []}
    for _ in range(4):
        once(series["main_thread"])
    for _ in range(4):
        in_thread(once, series["fresh_thread_each_call"])
    in_thread(lambda: [once(series["one_other_thread"]) for _ in range(4)])
    for name, calls in series.items():
        print(json.dumps({"series": name, "pages": len(pages),
                          "enqueue_ms": [c[0] for c in calls],
                          "total_ms": [c[1] for c in calls]}), flush=True)
    print(card_name_and_power_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
