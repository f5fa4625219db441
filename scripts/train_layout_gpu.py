"""Train the LayoutLM classifier and indexer on synthetic documents on the
card (the port's counterpart of ``scripts/train_layout.py``).

    python scripts/train_layout_gpu.py --out-dir <dir>

Writes ``layout-classifier-synth.npz`` and ``layout-indexer-synth.npz``
(the port's ``.npz`` trees) into ``--out-dir`` and prints the held-out
accuracies.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--out-dir", type=str, required=True)
    args = ap.parse_args()

    from marie_tpu_torch.train.layout import train_layout_classifier, train_layout_indexer

    _, _, clf_acc, _ = train_layout_classifier(
        steps=args.steps,
        checkpoint_path=os.path.join(args.out_dir, "layout-classifier-synth.npz"),
    )
    _, _, ner_acc, _ = train_layout_indexer(
        steps=args.steps,
        checkpoint_path=os.path.join(args.out_dir, "layout-indexer-synth.npz"),
    )
    print(f"CLASSIFIER_ACC={clf_acc:.4f} NER_TOKEN_ACC={ner_acc:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
