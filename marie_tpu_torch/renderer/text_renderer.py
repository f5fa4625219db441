"""Plain-text renderer with optional interword-space preservation (copy of
``marie_tpu/renderer/text_renderer.py``): word boxes mapped onto a
character grid of an average character width and height."""

from math import ceil
from typing import Any, Dict, List

from marie_tpu_torch.renderer.renderer import ResultRenderer


class TextRenderer(ResultRenderer):
    def __init__(self, config=None):
        super().__init__(config)
        self.preserve_interword_spaces = bool(
            self.config.get("preserve_interword_spaces", False)
        )
        self.char_width = float(self.config.get("char_width", 8.44))
        self.char_height = float(self.config.get("char_height", 16))

    @property
    def name(self) -> str:
        return "TextRenderer"

    def render_page(self, image, result: Dict[str, Any], page_index: int) -> str:
        self.check_format_xywh(result, True)
        words = result.get("words", [])
        lines = result.get("lines", [])
        if not words:
            return ""

        if not self.preserve_interword_spaces:
            ordered = sorted(lines, key=lambda l: l["line"])
            return "\n".join(l["text"] for l in ordered)

        # spatial layout: place each word at its column position
        w = result["meta"]["imageSize"]["width"]
        cols = ceil(w / self.char_width)
        out_lines: List[str] = []
        by_line: Dict[int, List[dict]] = {}
        for wd in words:
            by_line.setdefault(int(wd["line"]), []).append(wd)
        for line_no in sorted(by_line):
            row = [" "] * cols
            for wd in sorted(by_line[line_no], key=lambda d: d["box"][0]):
                col = min(int(wd["box"][0] / self.char_width), cols - 1)
                text = str(wd["text"])
                for k, ch in enumerate(text):
                    if col + k < cols:
                        row[col + k] = ch
            out_lines.append("".join(row).rstrip())
        return "\n".join(out_lines)

    def write(self, pages: List[str], output_filename: str) -> None:
        with open(output_filename, "w") as fp:
            fp.write("\n\f\n".join(pages))
