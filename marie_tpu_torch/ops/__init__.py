"""The port's compute ops (counterparts of ``marie_tpu/ops/``): box ops,
NMS (plain and rotated), ROIAlign (plain and rotated), rotated box IoU,
deformable convolution, connected components and CTC decode.  The two
hand-written CUDA kernels are in :mod:`marie_tpu_torch.ops.kernels`; they
build at their first launch, never at import.

As in the JAX package, the names ``nms``, ``roi_align``, ``rotated_iou``
and ``connected_components`` here are the functions: reach the modules
of those names through ``importlib.import_module``.
"""

from marie_tpu_torch.ops.box_ops import (
    box_area,
    box_iou,
    boxes_cxcywh_to_xyxy,
    boxes_xywh_to_xyxy,
    boxes_xyxy_to_xywh,
)
from marie_tpu_torch.ops.connected_components import (
    component_boxes,
    component_boxes_reduce,
    component_boxes_reduce2,
    component_boxes_runs,
    component_boxes_runs_cc,
    connected_components,
)
from marie_tpu_torch.ops.ctc import ctc_greedy_decode
from marie_tpu_torch.ops.deform_conv import deform_conv2d
from marie_tpu_torch.ops.nms import nms, rotated_nms
from marie_tpu_torch.ops.roi_align import roi_align, roi_align_rotated
from marie_tpu_torch.ops.rotated_iou import pairwise_rotated_iou, rotated_iou

__all__ = [
    "box_area",
    "box_iou",
    "boxes_xywh_to_xyxy",
    "boxes_xyxy_to_xywh",
    "boxes_cxcywh_to_xyxy",
    "nms",
    "rotated_nms",
    "rotated_iou",
    "pairwise_rotated_iou",
    "roi_align",
    "roi_align_rotated",
    "connected_components",
    "component_boxes",
    "component_boxes_reduce",
    "component_boxes_reduce2",
    "component_boxes_runs",
    "component_boxes_runs_cc",
    "deform_conv2d",
    "ctc_greedy_decode",
]
