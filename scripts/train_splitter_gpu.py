"""Train the page boundary/continuation splitter head on the card (the
port's counterpart of ``scripts/train_splitter.py``).

    python scripts/train_splitter_gpu.py --out <dir>/layout-splitter-synth.npz

Writes the trained tree as the port's ``.npz`` (``registry/checkpoints.py``),
which ``LayoutDocumentSplitter(config=LayoutLMConfig.synth(2),
params=load_params(path))`` serves; prints the held-out page and split
accuracy.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--out", type=str, required=True, help="the .npz tree to write")
    args = ap.parse_args()

    from marie_tpu_torch.train.layout import train_layout_splitter

    _, _, metrics, _ = train_layout_splitter(
        steps=args.steps, checkpoint_path=args.out,
    )
    print("SPLITTER_EVAL=" + json.dumps(metrics))
    print("DONE")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
