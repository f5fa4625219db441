"""Word detectors (port of ``marie_tpu/boxes``): the base and line
grouping, CRAFT, the weight-free ink detector, the DiT detector and
TextFuseNet."""

from marie_tpu_torch.boxes.box_processor import BoxProcessor
from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
from marie_tpu_torch.boxes.dit_box_processor import BoxProcessorUlimDit
from marie_tpu_torch.boxes.ink_box_processor import InkBoxProcessor
from marie_tpu_torch.boxes.line_processor import find_line_number, line_merge
from marie_tpu_torch.boxes.textfusenet_box_processor import BoxProcessorTextFuseNet
from marie_tpu_torch.enums import PSMode

__all__ = [
    "BoxProcessor",
    "PSMode",
    "BoxProcessorCraft",
    "BoxProcessorTextFuseNet",
    "BoxProcessorUlimDit",
    "InkBoxProcessor",
    "line_merge",
    "find_line_number",
]
