"""Word-level tokenizers for the layout heads (copy of
``marie_tpu/components/word_tokenizer.py``).

``HashWordTokenizer`` maps a word to a stable hash bucket (md5 of the
lowercased string); ``RollingWordTokenizer`` defines the id from the
recogniser's char ids, so the fused OCR chain can hash its own decode
output on the device (:func:`marie_tpu_torch.ocr.fused_chain.rolling_word_ids`)
and get the ids the host computes here.
"""

import hashlib
from typing import Sequence, Tuple

import numpy as np

from marie_tpu_torch.models.tokenizer import CharTokenizer

PAD_ID = 0
CLS_ID = 1
_RESERVED = 2


def _encode_boxes(ids, boxes, page_size, max_len: int, coord_buckets: int):
    """(tokens [max_len], xyxy bucket boxes [max_len, 4], count) from word
    ids and xywh page-pixel boxes."""
    pw, ph = max(page_size[0], 1), max(page_size[1], 1)
    n = min(len(ids), max_len)
    tokens = np.full((max_len,), PAD_ID, np.int32)
    nboxes = np.zeros((max_len, 4), np.int32)
    for i in range(n):
        tokens[i] = ids[i]
        x, y, w, h = boxes[i]
        nboxes[i] = [
            int(x / pw * (coord_buckets - 1)),
            int(y / ph * (coord_buckets - 1)),
            int(min((x + w) / pw, 1.0) * (coord_buckets - 1)),
            int(min((y + h) / ph, 1.0) * (coord_buckets - 1)),
        ]
    return tokens, np.clip(nboxes, 0, coord_buckets - 1), n


class HashWordTokenizer:
    def __init__(self, vocab_size: int = 50265, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase

    def token_id(self, word: str) -> int:
        if self.lowercase:
            word = word.lower()
        h = hashlib.md5(word.encode()).digest()
        return _RESERVED + int.from_bytes(h[:4], "little") % (self.vocab_size - _RESERVED)

    def encode_page(self, words: Sequence[str], boxes: Sequence[Sequence[float]],
                    page_size: Tuple[int, int], max_len: int, coord_buckets: int = 1024):
        """-> (tokens [max_len], norm_boxes [max_len, 4], seq_len int).

        Boxes come in as xywh page pixels, go out as xyxy bucket coords
        (0..coord_buckets - 1), the LayoutLM convention."""
        ids = [self.token_id(w) for w in words[:max_len]]
        return _encode_boxes(ids, boxes, page_size, max_len, coord_buckets)


class RollingWordTokenizer:
    """Word -> id computable on the device from recogniser char rows:

        h = sum_t (char_id_t + 1) * 31^t   (mod 2^32)
        id = RESERVED + h mod (vocab_size - RESERVED)
    """

    def __init__(self, vocab_size: int = 8192, char_tokenizer=None):
        self.vocab_size = vocab_size
        self.char_tokenizer = char_tokenizer or CharTokenizer()

    def token_id(self, word: str) -> int:
        ids = self.char_tokenizer.encode(word, add_eos=False)
        h, p = 0, 1  # uint32 wraparound via explicit masking
        for i in ids:
            h = (h + (i + 1) * p) & 0xFFFFFFFF
            p = (p * 31) & 0xFFFFFFFF
        return _RESERVED + h % (self.vocab_size - _RESERVED)

    def encode_page(self, words: Sequence[str], boxes: Sequence[Sequence[float]],
                    page_size: Tuple[int, int], max_len: int, coord_buckets: int = 1024):
        """Same contract as :meth:`HashWordTokenizer.encode_page`."""
        ids = [self.token_id(w) for w in words[:max_len]]
        return _encode_boxes(ids, boxes, page_size, max_len, coord_buckets)
