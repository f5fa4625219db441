#!/usr/bin/env python3
"""Two trees of the port, one card: the serving resamplers that the
trainers' slice rewrote, timed and compared at the serving shapes.

    python3 scripts/resample_ab.py --parent DIR

``DIR`` holds another checkout of the repo (``git archive`` of the
parent commit, unpacked).  The script runs itself once per tree, in the
order parent, this tree, this tree, parent, each in a process of its own
that imports only that tree's ``marie_tpu_torch``, and then prints one
JSON line a function: each run's median ms (CUDA events, ``REPS``
calls after ``WARM``) and the largest difference of this tree's output
from the parent's.  The functions, on seeded inputs:

* ``overlay_down`` / ``overlay_up``: ``resize_linear`` of the overlay's
  generator input and output (``_segment_batch_gray``: 4 pages of
  1024x768x3 bfloat16 to half size and back);
* ``register_resize``: ``resize_linear`` of a 1024x768 float32 frame to
  the boundary regressor's 192x256 (``DocumentBoundaryRegistration.corners``);
* ``register_warp``: ``warp_quad_to_page`` of a 1024x768 uint8 page
  (the single-page ``_bilinear_hwc``);
* ``tfn_roi_align``: ``roi_align_single`` of TextFuseNet's stride-4 P3
  map of a 1024x768 page (64 x 256 x 192) over 128 word and 512 char
  boxes at pool 7 (``TextFuseNet.fuse``).

Each child writes its outputs and times under ``chiprun_out/``; the
outputs are removed once compared.  Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "resample_ab")
WARM, REPS = 3, 20


def _cases():
    """{name: a call of the function on its inputs}, on the card, the
    inputs drawn from seed 0."""
    import importlib

    import numpy as np
    import torch

    from marie_tpu_torch.models.boundary import warp_quad_to_page
    from marie_tpu_torch.overlay.overlay import resize_linear

    roi = importlib.import_module("marie_tpu_torch.ops.roi_align")
    rng = np.random.default_rng(0)
    dev = "cuda"
    pages = torch.from_numpy(rng.integers(0, 256, (4, 1024, 768, 3), dtype=np.uint8)).to(dev)
    unit = (pages.float() * (1.0 / 127.5) - 1.0).to(torch.bfloat16)
    small = unit[:, ::2, ::2].contiguous()
    frame = pages[:1].float()
    quad = np.asarray([[40.5, 30.25], [730.0, 52.0], [745.5, 990.0], [20.0, 1000.5]], np.float32)
    feat = torch.from_numpy(rng.standard_normal((64, 256, 192), dtype=np.float32)).to(dev)
    xy = rng.uniform(0, 180, (640, 2)).astype(np.float32)
    wh = rng.uniform(2, 60, (640, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], axis=1)).to(dev)
    return {
        "overlay_down": (lambda: resize_linear(unit, 512, 384)),
        "overlay_up": (lambda: resize_linear(small, 1024, 768)),
        "register_resize": (lambda: resize_linear(frame, 192, 256)),
        "register_warp": (lambda: warp_quad_to_page(pages[0], quad, 1024, 768, device=dev)),
        "tfn_roi_align": (lambda: torch.cat([
            roi.roi_align_single(feat, boxes[:128], output_size=7, device=dev),
            roi.roi_align_single(feat, boxes[128:], output_size=7, device=dev)])),
    }


def child(tree: str, out: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import marie_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(marie_tpu_torch.__file__))) != tree:
        raise RuntimeError(f"imported {marie_tpu_torch.__file__}, not {tree}'s")
    times, outputs = {}, {}
    with torch.inference_mode():
        for name, fn in _cases().items():
            for _ in range(WARM):
                fn()
            ms = []
            for _ in range(REPS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                y = fn()
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            times[name] = float(np.median(ms))
            outputs[name] = y.float().cpu().numpy()
    np.savez(out, **outputs)
    with open(out + ".json", "w") as f:
        json.dump(times, f)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="the other checkout's root")
    parser.add_argument("--child", nargs=2, metavar=("TREE", "OUT"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(os.path.abspath(args.child[0]), args.child[1])
        return 0
    import numpy as np

    sys.path.insert(0, ROOT)
    from marie_tpu_torch.utils.device import card_name_and_power_limit

    os.makedirs(OUT, exist_ok=True)
    parent = os.path.abspath(args.parent)
    runs = [("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent)]
    paths = []
    for i, (label, tree) in enumerate(runs):
        path = os.path.join(OUT, f"{i}_{label}.npz")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree, path],
                       check=True, cwd=tree)
        paths.append((label, path))
    times = [json.load(open(p + ".json")) for _, p in paths]
    outs = [np.load(p) for _, p in paths]
    card = card_name_and_power_limit()
    for name in times[0]:
        a, b = outs[0][name], outs[1][name]
        diff = np.abs(a - b)
        print(json.dumps({"card": card, "function": name, "shape": list(a.shape),
                          "ms": {f"{i}_{label}": t[name] for i, ((label, _), t)
                                 in enumerate(zip(paths, times))},
                          "max_abs_diff": float(diff.max()),
                          "equal_share": float((diff == 0).mean()),
                          "parent_repeat_equal": bool(np.array_equal(a, outs[3][name])),
                          "change_repeat_equal": bool(np.array_equal(b, outs[2][name]))}),
              flush=True)
    for _, path in paths:
        os.remove(path)  # the outputs run to ~150 MB a run
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
