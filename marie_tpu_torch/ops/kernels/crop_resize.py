"""K1 — word-crop kernel wrapper.

Replaces the TPU kernel ``marie_tpu/ops/pallas/crop_resize.py``
(``crop_resize_pallas``).  On a CUDA tensor :func:`crop_resize` launches
the hand-written kernel of ``csrc/crop_resize.cu`` (bound by bytes: the
float32 crop store dominates; one block per (crop, 8 output rows), whose
source rows it stages in shared memory, and one thread per 4 output
columns; see the source note); on a CPU tensor it
runs the plain PyTorch version, :func:`crop_resize_plain`
(``preprocess/ops.py::crop_resize_pages``).  There is no fallback from
one to the other.
"""

import ctypes
from typing import Tuple

import torch

from marie_tpu_torch.ops.kernels import _build
from marie_tpu_torch.preprocess.ops import crop_resize_pages as crop_resize_plain

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("crop_resize")
    fn = lib.mt_crop_resize
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
    return lib


def crop_resize(
    pages: torch.Tensor,  # [P, H, W] uint8
    page_of: torch.Tensor,  # [N] int32
    boxes: torch.Tensor,  # [N, 4] float32 xyxy
    out_h: int,
    out_w: int,
    channel_mean: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(crops [N, out_h, out_w] float32 in [0, 1], eff_w [N] int32) — the
    function of :func:`crop_resize_plain` (``channel_mean``: the CRNN's
    channel mean of the crops, rounded as the JAX program rounds it)."""
    if pages.device.type == "cpu":
        return crop_resize_plain(pages, page_of, boxes, out_h, out_w, channel_mean)
    if pages.device.type != "cuda":
        raise ValueError(f"crop_resize: unsupported device {pages.device}")
    if pages.dtype != torch.uint8 or pages.ndim != 3:
        raise ValueError("crop_resize: pages must be a [P, H, W] uint8 tensor")
    if not 0 < out_w <= 4096 or out_h <= 0:
        raise ValueError(f"crop_resize: out_h must be > 0 and out_w in (0, 4096], "
                         f"got {out_h}x{out_w}")
    n = boxes.shape[0]
    if boxes.shape != (n, 4) or page_of.shape != (n,):
        raise ValueError("crop_resize: boxes must be [N, 4] and page_of [N]")
    for t in (page_of, boxes):
        if t.device != pages.device:
            raise ValueError("crop_resize: all inputs must be on one device")
    pages = pages.contiguous()
    page_of = page_of.to(torch.int32).contiguous()
    boxes = boxes.to(torch.float32).contiguous()
    crops = torch.empty((n, out_h, out_w), dtype=torch.float32, device=pages.device)
    eff_w = torch.empty((n,), dtype=torch.int32, device=pages.device)
    lib = _lib()
    p, h, w = pages.shape
    with torch.cuda.device(pages.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mt_crop_resize(
            pages.data_ptr(), page_of.data_ptr(), boxes.data_ptr(),
            crops.data_ptr(), eff_w.data_ptr(), n, p, h, w, out_h, out_w,
            int(channel_mean), stream,
        )
    if n > 0:
        _build.count_launch(crop_resize)
    _build.check(lib, code, "crop_resize")
    return crops, eff_w


#: launches of the CUDA kernel, in all and by path (the plain CPU path
#: does not count; see ``_build.count_launch``)
_build.reset_counts(crop_resize)
