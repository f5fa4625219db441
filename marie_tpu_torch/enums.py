"""The enums the port's OCR API takes (copy of ``BetterEnum``, ``PSMode``
and ``CoordinateFormat`` of ``marie_tpu/enums.py``).  The values are the
JAX package's, so a mode or format means the same on both sides."""

from enum import Enum


class BetterEnum(str, Enum):
    """String-valued enum that parses case-insensitively from YAML/CLI."""

    def __str__(self) -> str:
        return self.value

    @classmethod
    def from_string(cls, s: str) -> "BetterEnum":
        try:
            return cls(s.lower())
        except ValueError:
            raise ValueError(
                f"{s!r} is not a valid {cls.__name__}; choose from "
                f"{[e.value for e in cls]}"
            )


class PSMode(BetterEnum):
    """Page segmentation modes.

    * WORD       — treat the image as a single word
    * SPARSE     — find as much text as possible in no particular order
    * LINE       — treat the image as a single text line
    * RAW_LINE   — single text line, no bounding-box detection performed
    * MULTI_LINE — multiple text lines, no bounding-box detection performed
    """

    WORD = "word"
    SPARSE = "sparse"
    LINE = "line"
    RAW_LINE = "raw_line"
    MULTI_LINE = "multiline"

    @staticmethod
    def from_value(value: "str | None") -> "PSMode":
        if value is None:
            return PSMode.SPARSE
        for m in PSMode:
            if m.value == value.lower():
                return m
        return PSMode.SPARSE


class CoordinateFormat(BetterEnum):
    """Box coordinate convention."""

    XYWH = "xywh"
    XYXY = "xyxy"

    @staticmethod
    def convert(box, from_fmt: "CoordinateFormat", to_fmt: "CoordinateFormat"):
        if from_fmt == to_fmt:
            return list(box)
        x0, y0, a, b = box
        if from_fmt == CoordinateFormat.XYWH:  # -> xyxy
            return [x0, y0, x0 + a, y0 + b]
        return [x0, y0, a - x0, b - y0]  # xyxy -> xywh
