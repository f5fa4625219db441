"""DiT-style box processor (port of ``marie_tpu/boxes/dit_box_processor.py``):
a ViT backbone whose patch grid feeds a dense upsampling head, a text
region heatmap, then the run-domain connected components and their boxes,
as the CRAFT path does.

The model (:class:`~marie_tpu_torch.models.vit.DiTDetector`) runs in
float32 with TF32 kept out of its convolutions and matmuls; its attention
is the fused kernel (float32, counted on the ``"detectors"`` path).
"""

from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from marie_tpu_torch.boxes.box_processor import BoxProcessor, fit_page
from marie_tpu_torch.models.configs import ViTConfig
from marie_tpu_torch.models.vit import DiTDetector
from marie_tpu_torch.ops.connected_components import component_boxes_runs_cc
from marie_tpu_torch.ops.kernels._build import launch_path
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.preprocess.ops import normalize_page
from marie_tpu_torch.registry.convert import init_flax_layout, load_model
from marie_tpu_torch.registry.zoo import zoo_params
from marie_tpu_torch.utils.device import float32_precision, resolve_device

#: the seed of the weights drawn when the zoo holds no DiT tree
SEED = 0
#: the configuration ``BoxProcessorUlimDit()`` builds without a tree
DEFAULT_CONFIG = ViTConfig(
    image_size=(1024, 768), patch_size=16, hidden_dim=384,
    num_layers=6, num_heads=6, mlp_dim=1536, use_cls_token=False,
)
#: the zoo ladder: (tree, config), first found wins
ZOO_LADDER = (("dit-s1-synth", ViTConfig.dit_synth_s1), ("dit-synth", ViTConfig.dit_synth))


@torch.no_grad()
def dit_heatmap(model: DiTDetector, page_u8: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] uint8 page -> the [h, w, 2] heatmap, float32 with TF32
    kept out; the attention's launches count on ``"detectors"``."""
    with record_function("marie.detect"), launch_path("detectors"), \
            float32_precision(False):
        return model(normalize_page(page_u8)[None])[0]


@torch.no_grad()
def dit_detect(model: DiTDetector, page_u8: torch.Tensor, low_text: float,
               max_components: int):
    """[H, W, 3] uint8 page -> component stats of the region map masked
    at ``low_text`` (the JAX ``_dit_detect_jit``)."""
    region = dit_heatmap(model, page_u8)[..., 0]
    with record_function("marie.cc"):
        return component_boxes_runs_cc(region > low_text, region,
                                       max_components=max_components, max_runs_per_row=64)


class BoxProcessorUlimDit(BoxProcessor):
    """The DiT detector with the shared box pipeline (the JAX package's
    ``BoxProcessorUlimDit``), on ``device`` (the card unless the caller
    asks for the CPU).

    Without ``config`` and ``variables`` the zoo's ``dit-s1-synth``, then
    ``dit-synth`` (``torch_zoo/``) are tried; without either the JAX
    fallback configuration (:data:`DEFAULT_CONFIG`) is built with weights
    from seed :data:`SEED` (``zoo_name`` None).  ``variables`` is a
    flax-layout numpy tree."""

    #: the zoo tree the weights came from (None: passed in or seeded)
    zoo_name: Optional[str] = None

    def __init__(
        self,
        config: Optional[ViTConfig] = None,
        variables=None,
        text_threshold: float = 0.7,
        low_text: float = 0.8,
        min_area: int = 4,
        max_components: int = 1024,
        bucket_spec: Optional[BucketSpec] = None,
        unshrink: bool = True,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if variables is None and config is None:
            for name, cfg_fn in ZOO_LADDER:
                variables = zoo_params(name)
                if variables is not None:
                    config, self.zoo_name = cfg_fn(), name
                    break
        self.config = config or DEFAULT_CONFIG
        self.text_threshold = text_threshold
        self.low_text = low_text
        self.unshrink = unshrink
        self.min_area = min_area
        self.max_components = max_components
        self.buckets = bucket_spec or BucketSpec(shapes=(tuple(self.config.image_size),))
        if variables is None:
            variables = init_flax_layout(self.config, SEED)
        self.model = load_model(self.config, variables, self.device)

    def detect_words(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        h, w = image.shape[:2]
        page_dev, scale = fit_page(image, self.buckets, self.device)
        stats = dit_detect(self.model, page_dev, self.low_text, self.max_components)
        stats = {k: v.cpu().numpy() for k, v in stats.items()}
        keep = (
            stats["valid"]
            & (stats["scores"] >= self.text_threshold)
            & (stats["areas"] >= self.min_area)
        )
        boxes = stats["boxes"][keep] * float(self.config.head_stride) / scale
        if self.unshrink and len(boxes):
            # undo the training-target shrink and the threshold erosion, so
            # the boxes match the unshrunk word extent the recogniser crops
            # expect; the constants are the JAX processor's, per head
            bw_ = boxes[:, 2] - boxes[:, 0]
            bh_ = boxes[:, 3] - boxes[:, 1]
            if self.config.subpixel > 1:
                ex = bw_ / 16.0 + 0.5
                ey = np.zeros_like(bh_)
            else:
                ex = bw_ / 8.0 + 1.0
                ey = bh_ / 18.0 + 1.0
            boxes = np.stack(
                [boxes[:, 0] - ex, boxes[:, 1] - ey, boxes[:, 2] + ex, boxes[:, 3] + ey],
                axis=-1,
            )
        xywh = np.stack(
            [
                np.clip(boxes[:, 0], 0, w),
                np.clip(boxes[:, 1], 0, h),
                np.clip(boxes[:, 2], 0, w) - np.clip(boxes[:, 0], 0, w),
                np.clip(boxes[:, 3], 0, h) - np.clip(boxes[:, 1], 0, h),
            ],
            axis=-1,
        )
        ok = (xywh[:, 2] > 0) & (xywh[:, 3] > 0)
        return xywh[ok], stats["scores"][keep][ok]
