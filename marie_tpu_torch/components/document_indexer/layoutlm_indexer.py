"""Document indexer (NER / key-value extraction) over LayoutLM token
classification (port of
``marie_tpu/components/document_indexer/layoutlm_indexer.py``): a page's
words go through a stack of ``window``-token windows at ``stride`` (all
windows of a page in one batch), the window logits are overlap-averaged,
and the BIO tags are decoded into entities, validated and optionally
grouped into composite entities by line.  ``from_zoo`` and
``from_zoo_chain`` load the trained heads of ``torch_zoo/``
(:mod:`marie_tpu_torch.registry.zoo`).
"""

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from marie_tpu_torch.boxes.line_processor import line_merge
from marie_tpu_torch.components.base import BaseDocumentIndexer, PageInput
from marie_tpu_torch.components.document_indexer.aggregation import group_composites
from marie_tpu_torch.components.document_indexer.validator import get_validator
from marie_tpu_torch.components.word_tokenizer import HashWordTokenizer, RollingWordTokenizer
from marie_tpu_torch.models.configs import LayoutLMConfig
from marie_tpu_torch.models.layoutlm import merge_window_logits, sliding_windows
from marie_tpu_torch.ops.kernels._build import launch_path
from marie_tpu_torch.registry.convert import init_flax_layout, load_model
from marie_tpu_torch.registry.zoo import zoo_params
from marie_tpu_torch.utils.device import float32_precision, resolve_device

SYNTH_NER_LABELS = ("O", "B-KEY", "I-KEY", "B-VALUE", "I-VALUE")


class LayoutDocumentIndexer(BaseDocumentIndexer):
    """Per page {"entities": [...]} (+ "groups").  ``params`` is a
    flax-layout numpy tree; without one the weights are drawn from seed
    0.  Port-only keyword: ``device``."""

    #: the zoo tree the weights came from (None: passed in or seeded)
    zoo_name: Optional[str] = None

    @classmethod
    def from_zoo(cls, name: str = "layout-indexer-synth", labels=SYNTH_NER_LABELS,
                 *, device="cuda") -> "Optional[LayoutDocumentIndexer]":
        """The zoo's synthetic-trained indexer, or None when absent."""
        params = zoo_params(name)
        if params is None:
            return None
        head = cls(labels=labels, config=LayoutLMConfig.synth(num_labels=len(labels)),
                   params=params, device=device)
        head.zoo_name = name
        return head

    @classmethod
    def from_zoo_chain(cls, name: str = "layout-indexer-chain", labels=SYNTH_NER_LABELS,
                       *, device="cuda") -> "Optional[LayoutDocumentIndexer]":
        """The head trained for the fused chain (``RollingWordTokenizer``
        ids, sequence cap 192), or None when absent."""
        params = zoo_params(name)
        if params is None:
            return None
        config = dataclasses.replace(LayoutLMConfig.synth(num_labels=len(labels)),
                                     max_seq_len=192)
        head = cls(labels=labels, config=config, params=params,
                   tokenizer=RollingWordTokenizer(config.vocab_size), device=device)
        head.zoo_name = name
        return head

    def __init__(
        self,
        labels: Sequence[str] = SYNTH_NER_LABELS,
        config: Optional[LayoutLMConfig] = None,
        params=None,
        tokenizer: Optional[HashWordTokenizer] = None,
        window: Optional[int] = None,
        stride: int = 128,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.labels = list(labels)
        self.config = config or LayoutLMConfig.base(num_labels=len(self.labels))
        self.tokenizer = tokenizer or HashWordTokenizer(self.config.vocab_size)
        self.window = window or self.config.max_seq_len
        self.stride = min(stride, self.window)
        if params is None:
            params = init_flax_layout(self.config, 0, "token")
        self.model = load_model(self.config, params, self.device, head="token")

    def index(self, pages: Sequence[PageInput],
              entities_to_group: Optional[Sequence[Dict[str, Any]]] = None,
              validate: bool = True) -> List[Dict[str, Any]]:
        """Per page: {"entities": [...], "groups": {...}}.

        ``entities_to_group`` definitions ([{"name", "entities"}]) turn
        word-level predictions into line-aggregated EntityGroups; the
        registered validators add ``normalized``/``valid`` fields."""
        out = []
        for page in pages:
            result = self._index_page(page)
            if validate:
                self._apply_validators(result["entities"])
            if entities_to_group and page.boxes:
                result["groups"] = self._group_entities(page, result, entities_to_group)
            out.append(result)
        return out

    def _apply_validators(self, entities: List[Dict[str, Any]]) -> None:
        for e in entities:
            v = get_validator(e["label"])
            if v is None:
                continue
            try:
                e["normalized"] = v(e["text"])
                e["valid"] = True
            except ValueError as err:
                e["valid"] = False
                e["validation_error"] = str(err)

    def _group_entities(self, page, result, definitions):
        n = len(page.words)
        # word-level BIO tags from the decoded entities
        predictions = ["O"] * n
        scores = [0.0] * n
        for e in result["entities"]:
            s, t = e["word_span"]
            for i in range(s, min(t, n)):
                predictions[i] = ("B-" if i == s else "I-") + e["label"]
                scores[i] = e["score"]
        lines_bboxes = line_merge(np.zeros((1, 1), np.uint8), page.boxes)
        groups = group_composites(definitions, lines_bboxes, page.boxes, predictions, scores)
        return {name: [dataclasses.asdict(g) for g in gs] for name, gs in groups.items()}

    @torch.no_grad()
    def logits(self, page: PageInput) -> torch.Tensor:
        """[words, labels] float32 overlap-averaged logits on the device
        (a page has at least one word)."""
        n = len(page.words)
        t, b, _ = self.tokenizer.encode_page(
            page.words, page.boxes, page.page_size, n, self.config.max_2d_pos)
        tokens = torch.from_numpy(t).to(self.device)
        boxes = torch.from_numpy(b).to(self.device)
        win_t, win_b, starts, valid = sliding_windows(tokens, boxes, window=self.window,
                                                      stride=self.stride)
        seq_len = valid.sum(dim=1).to(torch.int32)
        with record_function("marie.heads"), launch_path("heads"), float32_precision(False):
            logits = self.model(win_t, win_b, seq_len)
        return merge_window_logits(logits, starts, valid, n)

    def _index_page(self, page: PageInput) -> Dict[str, Any]:
        if not page.words:
            return {"entities": []}
        probs = torch.softmax(self.logits(page), dim=-1).cpu().numpy()
        pred = probs.argmax(axis=-1)
        return {"entities": self._bio_decode(pred, probs, page.words)}

    def _bio_decode(self, pred, probs, words) -> List[Dict[str, Any]]:
        """Aggregate BIO tags into entities with word spans."""
        entities = []
        cur = None
        for i, p in enumerate(pred):
            label = self.labels[int(p)]
            score = float(probs[i, int(p)])
            if label.startswith("B-") or (
                    label.startswith("I-") and (cur is None or cur["label"] != label[2:])):
                if cur:
                    entities.append(cur)
                cur = {"label": label[2:], "words": [words[i]], "scores": [score],
                       "word_span": [i, i + 1]}
            elif label.startswith("I-") and cur is not None:
                cur["words"].append(words[i])
                cur["scores"].append(score)
                cur["word_span"][1] = i + 1
            else:  # O
                if cur:
                    entities.append(cur)
                    cur = None
        if cur:
            entities.append(cur)
        return [
            {
                "label": e["label"],
                "text": " ".join(e["words"]),
                "score": float(np.mean(e["scores"])),
                "word_span": tuple(e["word_span"]),
            }
            for e in entities
        ]
