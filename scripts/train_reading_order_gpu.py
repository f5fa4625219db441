"""Train the reading-order ranker on synthetic layouts on the card (the
port's counterpart of ``scripts/train_reading_order.py``): the page pool
on the device, ``train_reading_order_device``.

    python scripts/train_reading_order_gpu.py --out-dir <dir>

Writes ``reading-order-synth.npz`` (the port's ``.npz`` tree, which
``document/layoutreader.py::load_text_layout`` serves from ``torch_zoo/``)
into ``--out-dir`` and prints the last batch's pair accuracy and the
held-out Kendall tau.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--out-dir", type=str, required=True)
    args = ap.parse_args()

    from marie_tpu_torch.train.reading_order import train_reading_order_device

    _, _, pair_acc, tau = train_reading_order_device(
        steps=args.steps,
        batch_size=args.batch,
        checkpoint_path=os.path.join(args.out_dir, "reading-order-synth.npz"),
        device="cpu" if args.cpu else "cuda",
    )
    print(f"PAIR_ACC={pair_acc:.4f} KENDALL_TAU={tau:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
