"""Character tokenizers (copies of ``marie_tpu/models/tokenizer.py``'s
:class:`CharTokenizer` and :class:`CTCCharTokenizer`): printable-ASCII
charset with fixed special ids bos=0, eos=1, pad=2, unk=3, matching
:class:`DecoderConfig`; for the CTC head, blank=0 and the characters
from 1."""

import string
from typing import List, Sequence

import numpy as np

BOS_ID, EOS_ID, PAD_ID, UNK_ID = 0, 1, 2, 3
_SPECIALS = 4

DEFAULT_CHARSET = string.printable[:-5]  # no \t\n\r\x0b\x0c


class CharTokenizer:
    """Character-level tokenizer with fixed special ids."""

    def __init__(self, charset: str = DEFAULT_CHARSET):
        self.charset = charset
        self._c2i = {c: i + _SPECIALS for i, c in enumerate(charset)}
        self._i2c = {i + _SPECIALS: c for i, c in enumerate(charset)}

    @property
    def vocab_size(self) -> int:
        return len(self.charset) + _SPECIALS

    @property
    def bos_id(self) -> int:
        return BOS_ID

    @property
    def eos_id(self) -> int:
        return EOS_ID

    @property
    def pad_id(self) -> int:
        return PAD_ID

    def encode(self, text: str, max_len: int | None = None,
               add_eos: bool = True) -> List[int]:
        ids = [self._c2i.get(c, UNK_ID) for c in text]
        if add_eos:
            ids.append(EOS_ID)
        if max_len is not None:
            ids = ids[:max_len]
            ids = ids + [PAD_ID] * (max_len - len(ids))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i == EOS_ID:
                break
            if i in (BOS_ID, PAD_ID, UNK_ID) or i < 0:
                continue
            out.append(self._i2c.get(i, ""))
        return "".join(out)

    def decode_batch(self, token_matrix) -> List[str]:
        """[B, L] array-like -> list of strings, in one numpy pass: chars
        strictly before each row's first EOS, specials skipped."""
        ids = np.asarray(token_matrix)
        if ids.ndim == 1:
            ids = ids[None]
        if ids.size == 0:
            return ["" for _ in range(ids.shape[0])]
        ids = ids.astype(np.int64, copy=False)
        after_eos = np.cumsum(ids == EOS_ID, axis=1) > 0
        valid = (~after_eos) & (ids >= _SPECIALS) & (ids < self.vocab_size)
        lut = np.zeros(self.vocab_size, np.uint8)
        for ch, i in self._c2i.items():
            lut[i] = ord(ch)
        codes = lut[np.where(valid, ids, 0)]
        return [
            codes[r][valid[r]].tobytes().decode("ascii")
            for r in range(ids.shape[0])
        ]


class CTCCharTokenizer(CharTokenizer):
    """Charset mapping for the CTC head: blank=0, chars start at 1."""

    def __init__(self, charset: str = DEFAULT_CHARSET):
        self.charset = charset
        self._c2i = {c: i + 1 for i, c in enumerate(charset)}
        self._i2c = {i + 1: c for i, c in enumerate(charset)}

    @property
    def vocab_size(self) -> int:
        return len(self.charset) + 1

    @property
    def blank_id(self) -> int:
        return 0

    def encode(self, text: str) -> List[int]:  # type: ignore[override]
        return [self._c2i[c] for c in text if c in self._c2i]

    def decode(self, ids: Sequence[int]) -> str:  # type: ignore[override]
        return "".join(self._i2c.get(int(i), "") for i in ids if int(i) > 0)

    def decode_batch(self, token_matrix) -> List[str]:  # type: ignore[override]
        """CTC id layout has no EOS/specials — keep every id > 0."""
        ids = np.asarray(token_matrix)
        if ids.ndim == 1:
            ids = ids[None]
        if ids.size == 0:
            return ["" for _ in range(ids.shape[0])]
        ids = ids.astype(np.int64, copy=False)
        valid = (ids > 0) & (ids < self.vocab_size)
        lut = np.zeros(self.vocab_size, np.uint8)
        for ch, i in self._c2i.items():
            lut[i] = ord(ch)
        codes = lut[np.where(valid, ids, 0)]
        return [
            codes[r][valid[r]].tobytes().decode("ascii")
            for r in range(ids.shape[0])
        ]
