"""BLOBS XML renderer (copy of ``marie_tpu/renderer/blob_renderer.py``;
upstream marie's wire format): per-page ``<blobs>`` docs with one
``<blob x y w h text>`` per word."""

import os
import xml.etree.ElementTree as ET
from typing import Any, Dict, List
from xml.sax.saxutils import escape

from marie_tpu_torch.renderer.renderer import ResultRenderer


class BlobRenderer(ResultRenderer):
    @property
    def name(self) -> str:
        return "BlobRenderer"

    def render_page(self, image, result: Dict[str, Any], page_index: int) -> ET.ElementTree:
        self.check_format_xywh(result, True)
        root = ET.Element("blobs")
        root.set("angle", "0.0")
        root.set("yres", str(self.config.get("yres", 300)))
        root.set("xres", str(self.config.get("xres", 300)))
        root.set("page", str(page_index))
        for word in result.get("words", []):
            x, y, w, h = word["box"]
            el = ET.Element("blob")
            el.set("x", str(x))
            el.set("y", str(y))
            el.set("w", str(w))
            el.set("h", str(h))
            el.set("text", escape(str(word["text"])))
            page_el = ET.SubElement(el, "page")
            page_el.text = str(page_index + 1)
            root.append(el)
        return ET.ElementTree(root)

    def write(self, pages: List[ET.ElementTree], output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        for i, tree in enumerate(pages):
            tree.write(os.path.join(output_dir, f"{i + 1}.BLOBS.XML"))
