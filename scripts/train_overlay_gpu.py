"""Train the pix2pix overlay-cleanup generator on synthetic pairs on the card
(the port's counterpart of ``scripts/train_overlay.py``):
``train_overlay_device`` at the JAX recipe (3,000 steps, batch 4, 192
pairs of 512x384, the synth generator).

    python scripts/train_overlay_gpu.py --out <file.npz> [--steps N] [--batch-size B]

Writes the generator's flax-layout tree to ``--out`` (a ``.npz`` outside
``torch_zoo/``), prints ``OVERLAY_EVAL=`` (the held-out figures: 32 pairs,
seed 9999) and ``DONE`` as the JAX script does, and before them one JSON
line: the card's name and power limit, the wall seconds, ms a step,
steps/s, the host's render rate, the peak memory allocated, the figures
again from the written tree read back through ``registry/checkpoints.py``
into ``overlay/overlay.py::OverlayProcessor``'s float32 generator, and
``golden_train.json``'s figures of the JAX-trained ``pix2pix-synth``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--out", type=str, required=True,
                    help="the tree's .npz (outside torch_zoo/)")
    args = ap.parse_args()

    import torch

    from marie_tpu_torch.models.configs import Pix2PixConfig
    from marie_tpu_torch.overlay.overlay import OverlayProcessor
    from marie_tpu_torch.registry.checkpoints import load_params
    from marie_tpu_torch.registry.zoo import ZOO_DIR, open_zoo_json
    from marie_tpu_torch.train import overlay as tov
    from marie_tpu_torch.utils.device import card_name_and_power_limit

    out = os.path.abspath(args.out)
    if os.path.commonpath([out, os.path.abspath(ZOO_DIR)]) == os.path.abspath(ZOO_DIR):
        ap.error("--out lies in torch_zoo/: write the tree elsewhere")
    torch.cuda.reset_peak_memory_stats()
    timing = {}
    t0 = time.perf_counter()
    _, _, metrics = tov.train_overlay_device(
        steps=args.steps, batch_size=args.batch_size, checkpoint_path=out, device="cuda",
        timing=timing)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    proc = OverlayProcessor(config=Pix2PixConfig.synth(), variables=load_params(out),
                            compute_dtype="float32", device="cuda")
    reloaded = tov.evaluate_overlay(proc.models["float32"], None, (512, 384), n_pages=32,
                                    seed=9999)
    with open_zoo_json("golden_train") as f:
        golden = json.load(f)["overlay"]
    print(json.dumps({"card": card_name_and_power_limit(),
                      "steps": args.steps, "batch": args.batch_size,
                      "wall_s": wall, **timing,
                      "peak_mib": peak, "heldout": metrics, "reloaded": reloaded,
                      "reloaded_equal": reloaded == metrics, "golden": golden}), flush=True)
    print("OVERLAY_EVAL=" + json.dumps(metrics))
    print("DONE")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
