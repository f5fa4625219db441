"""Searchable-PDF renderer — page images with an invisible text layer
(port of ``marie_tpu/renderer/pdf_renderer.py``, in the same format):
each page is a ``/DCTDecode`` RGB image XObject drawn full-page plus
invisible (``3 Tr``) Helvetica text at the word boxes in a Flate content
stream, so text selection and search work in any viewer.  The JPEG comes
from :func:`marie_tpu_torch.utils.image_io.encode_jpeg` (quality 80,
4:2:0, as PIL's default), not PIL.  :func:`read_pdf` reads such a PDF
back for checks.
"""

import io
import re
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np

from marie_tpu_torch.renderer.renderer import ResultRenderer


def _esc(text: str) -> str:
    return text.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")


class _PdfBuilder:
    """Minimal PDF 1.4 writer."""

    def __init__(self):
        self.objects: List[bytes] = []  # 1-indexed bodies (without obj header)

    def add(self, body: bytes) -> int:
        self.objects.append(body)
        return len(self.objects)

    def build(self) -> bytes:
        out = io.BytesIO()
        out.write(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = [0]
        for i, body in enumerate(self.objects, start=1):
            offsets.append(out.tell())
            out.write(f"{i} 0 obj\n".encode())
            out.write(body)
            out.write(b"\nendobj\n")
        xref_pos = out.tell()
        n = len(self.objects) + 1
        out.write(f"xref\n0 {n}\n".encode())
        out.write(b"0000000000 65535 f \n")
        for off in offsets[1:]:
            out.write(f"{off:010d} 00000 n \n".encode())
        out.write(
            f"trailer\n<< /Size {n} /Root 1 0 R >>\nstartxref\n{xref_pos}\n%%EOF\n".encode()
        )
        return out.getvalue()


class PdfRenderer(ResultRenderer):
    @property
    def name(self) -> str:
        return "PdfRenderer"

    def render_page(self, image: np.ndarray, result: Dict[str, Any], page_index: int):
        """ALL the per-page CPU cost lives here (JPEG encode + content
        stream deflate) so the incremental ``feed`` path renders pages
        while the device executes later OCR groups; ``write`` only
        assembles pre-encoded blobs into the object graph."""
        from marie_tpu_torch.utils.image_io import encode_jpeg

        self.check_format_xywh(result, True)
        image = np.asarray(image)
        h, w = image.shape[0], image.shape[1]
        # image XObject: an RGB JPEG (a gray page is encoded as its RGB
        # stack, whose chroma blocks are all zero)
        if image.ndim == 3 and image.shape[2] == 1:
            image = image[..., 0]
        jpg = encode_jpeg(image if image.ndim == 2 else image[..., :3])

        # content stream: draw image full page, then invisible text
        ops = [f"q {w} 0 0 {h} 0 0 cm /Im0 Do Q".encode()]
        ops.append(b"BT 3 Tr")
        for word in result.get("words", []):
            x, y, bw, bh = word["box"]
            font_size = max(float(bh), 1.0)
            ty = h - y - bh  # PDF origin is bottom-left
            text = _esc(str(word["text"]))
            if not text:
                continue
            # horizontal squeeze so the glyphs span the box width
            est_w = 0.5 * font_size * max(len(text), 1)
            tz = max(min(100.0 * bw / est_w, 500.0), 10.0)
            ops.append(
                f"/F1 {font_size:.1f} Tf {tz:.0f} Tz 1 0 0 1 {x:.1f} {ty:.1f} Tm ({text}) Tj".encode()
            )
        ops.append(b"ET")
        comp = zlib.compress(b"\n".join(ops))
        return (w, h, jpg, comp)

    def write(self, pages: List[Tuple[int, int, bytes, bytes]], output_filename: str) -> None:
        pdf = _PdfBuilder()
        catalog_id = pdf.add(b"")  # placeholder: 1
        pages_id = pdf.add(b"")  # placeholder: 2
        font_id = pdf.add(
            b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>"
        )

        page_ids = []
        for w, h, jpg, comp in pages:
            img_id = pdf.add(
                (
                    f"<< /Type /XObject /Subtype /Image /Width {w} /Height {h} "
                    f"/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /DCTDecode "
                    f"/Length {len(jpg)} >>\nstream\n"
                ).encode()
                + jpg
                + b"\nendstream"
            )
            content_id = pdf.add(
                f"<< /Length {len(comp)} /Filter /FlateDecode >>\nstream\n".encode()
                + comp
                + b"\nendstream"
            )
            page_id = pdf.add(
                (
                    f"<< /Type /Page /Parent {pages_id} 0 R "
                    f"/MediaBox [0 0 {w} {h}] "
                    f"/Resources << /XObject << /Im0 {img_id} 0 R >> "
                    f"/Font << /F1 {font_id} 0 R >> >> "
                    f"/Contents {content_id} 0 R >>"
                ).encode()
            )
            page_ids.append(page_id)

        kids = " ".join(f"{pid} 0 R" for pid in page_ids)
        pdf.objects[catalog_id - 1] = f"<< /Type /Catalog /Pages {pages_id} 0 R >>".encode()
        pdf.objects[pages_id - 1] = (
            f"<< /Type /Pages /Kids [{kids}] /Count {len(page_ids)} >>".encode()
        )
        with open(output_filename, "wb") as fp:
            fp.write(pdf.build())


_STREAM = re.compile(
    rb"/Width (\d+) /Height (\d+) /ColorSpace /DeviceRGB /BitsPerComponent 8 "
    rb"/Filter /DCTDecode /Length (\d+) >>\nstream\n"
    rb"|<< /Length (\d+) /Filter /FlateDecode >>\nstream\n")


def read_pdf(data: bytes) -> List[Dict[str, Any]]:
    """The pages of a PDF this renderer wrote, in order: each page's image
    ``width`` and ``height``, its ``jpeg`` bytes and its inflated
    ``content`` stream.  Other PDFs are not read."""
    pages: List[Dict[str, Any]] = []
    for m in _STREAM.finditer(data):
        if m.group(3) is not None:
            body = data[m.end():m.end() + int(m.group(3))]
            pages.append({"width": int(m.group(1)), "height": int(m.group(2)), "jpeg": body})
        else:
            body = data[m.end():m.end() + int(m.group(4))]
            pages[-1]["content"] = zlib.decompress(body)
    return pages
