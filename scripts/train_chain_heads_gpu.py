#!/usr/bin/env python
"""Train the LayoutLM classifier and NER heads of the fused chain
(``ocr/fused_chain.py``) on the card (the port's counterpart of
``scripts/train_chain_heads.py``): ``RollingWordTokenizer`` ids (which the
chain computes on the device from the recogniser's char tokens), shuffled
word order (the chain feeds words in CC-slot order), ``max_seq_len`` 192
(the chain's rows a page).

    python scripts/train_chain_heads_gpu.py --out-dir <dir>

Writes ``layout-classifier-chain.npz`` and ``layout-indexer-chain.npz``
(the port's ``.npz`` trees, which ``LayoutDocumentClassifier.from_zoo_chain``
and ``LayoutDocumentIndexer.from_zoo_chain`` load from ``torch_zoo/``)
into ``--out-dir``.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from marie_tpu_torch.components.word_tokenizer import RollingWordTokenizer  # noqa: E402
from marie_tpu_torch.models.configs import LayoutLMConfig  # noqa: E402
from marie_tpu_torch.train.layout import (  # noqa: E402
    CLASS_POOLS,
    train_layout_classifier,
    train_layout_indexer,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", type=str, required=True)
    args = ap.parse_args()

    cls_cfg = dataclasses.replace(LayoutLMConfig.synth(len(CLASS_POOLS)), max_seq_len=192)
    _, _, acc, _ = train_layout_classifier(
        config=cls_cfg,
        tokenizer=RollingWordTokenizer(cls_cfg.vocab_size),
        shuffle_words=True,
        steps=2000,
        checkpoint_path=os.path.join(args.out_dir, "layout-classifier-chain.npz"),
    )
    print(f"classifier-chain held-out acc={acc:.4f}", flush=True)

    ner_cfg = dataclasses.replace(LayoutLMConfig.synth(5), max_seq_len=192)
    _, _, tok_acc, _ = train_layout_indexer(
        config=ner_cfg,
        tokenizer=RollingWordTokenizer(ner_cfg.vocab_size),
        shuffle_words=True,
        steps=2000,
        checkpoint_path=os.path.join(args.out_dir, "layout-indexer-chain.npz"),
    )
    print(f"indexer-chain held-out token acc={tok_acc:.4f}", flush=True)


if __name__ == "__main__":
    main()
