"""Adlib XML renderer (copy of ``marie_tpu/renderer/adlib_renderer.py``;
upstream marie's wire format): per-page ``<PAGE>`` docs with
``TEXTSTRING`` elements in inch coordinates (300 dpi), plus a
``summary.xml`` listing page files."""

import os
import xml.etree.ElementTree as ET
from datetime import datetime
from typing import Any, Callable, Dict, List

from marie_tpu_torch.renderer.renderer import ResultRenderer


class AdlibRenderer(ResultRenderer):
    def __init__(self, summary_filename: str = "summary.xml", config=None):
        super().__init__(config)
        self.summary_filename = summary_filename
        self.dpi_x = float(self.config.get("dpi_x", 300.0))
        self.dpi_y = float(self.config.get("dpi_y", 300.0))

    @property
    def name(self) -> str:
        return "AdlibRenderer"

    def render_page(self, image, result: Dict[str, Any], page_index: int) -> ET.ElementTree:
        self.check_format_xywh(result, True)
        meta = result["meta"]
        pagenumber = page_index + 1
        root = ET.Element("PAGE")
        root.set("HEIGHT", str(meta["imageSize"]["height"] / self.dpi_y))
        root.set("WIDTH", str(meta["imageSize"]["width"] / self.dpi_x))
        root.set("ImageType", "Unknown")
        root.set("NUMBER", str(pagenumber))
        root.set("OCREndTime", "0")
        root.set("OCRStartTime", "0")
        root.set("Producer", "marie")
        root.set("XRESOLUTION", str(self.dpi_x))
        root.set("YRESOLUTION", str(self.dpi_y))
        root.append(ET.Element("TEXT"))

        for word in result.get("words", []):
            x1, y1, w1, h1 = word["box"]
            x, y = x1 / self.dpi_x, y1 / self.dpi_y
            w, h = w1 / self.dpi_x, h1 / self.dpi_y
            el = ET.Element("TEXTSTRING")
            el.set("CONSECUTIVE", "FALSE")
            el.set("FONTNAME", "Courier")
            el.set("FONTSIZE", "32")
            el.set("NoLocation", "FALSE")
            el.set("PageNumber", str(pagenumber))
            el.set("LEFT", f"{x:.4f}")
            el.set("RIGHT", f"{x + w:.4f}")
            el.set("TOP", f"{y - h:.4f}")
            el.set("BOTTOM", f"{y + h:.4f}")
            el.set("WORD", str(word["text"]))
            root.append(el)
        return ET.ElementTree(root)

    def write_summary(
        self, num_pages: int, filename_generator: Callable[[int], str]
    ) -> ET.ElementTree:
        root = ET.Element("OCR")
        metas = ET.Element("METADATAELEMENTS")
        for field, val in (
            ("OCR", "MARIE-AI"),
            ("CreationDate", datetime.now().strftime("%Y-%m-%d %H:%M:%S")),
        ):
            el = ET.Element("METADATAELEMENT")
            el.set("FIELD", field)
            el.set("VALUE", val)
            metas.append(el)
        root.append(metas)
        pages = ET.Element("PAGES")
        for i in range(num_pages):
            node = ET.Element("PAGE")
            node.set("Filename", filename_generator(i + 1))
            node.set("NUMBER", str(i + 1))
            pages.append(node)
        root.append(pages)
        return ET.ElementTree(root)

    def write(self, pages: List[ET.ElementTree], output_dir: str) -> None:
        """Writes one XML per page into ``output_dir`` plus the summary."""
        os.makedirs(output_dir, exist_ok=True)

        def fname(n: int) -> str:
            return f"{n}.tif.xml"

        for i, tree in enumerate(pages):
            tree.write(os.path.join(output_dir, fname(i + 1)))
        self.write_summary(len(pages), fname).write(
            os.path.join(output_dir, self.summary_filename)
        )
