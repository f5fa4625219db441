"""TextFuseNet box processor (port of
``marie_tpu/boxes/textfusenet_box_processor.py``): the dense forward, word
candidates from the region map's run-domain connected components, char
candidates from the char map's pixel components (``component_boxes``
over :func:`connected_components`; dense char rows can exceed a run
budget), then the fuse module's score and refined box per word.  The
model runs in float32 with TF32 kept out of its convolutions and matmuls.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from marie_tpu_torch.boxes.box_processor import BoxProcessor, fit_page
from marie_tpu_torch.models.textfusenet import TextFuseNet, TextFuseNetConfig
from marie_tpu_torch.ops.connected_components import (
    component_boxes,
    component_boxes_runs_cc,
    connected_components,
)
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.preprocess.ops import normalize_page
from marie_tpu_torch.registry.convert import init_flax_layout, load_model
from marie_tpu_torch.registry.zoo import zoo_params
from marie_tpu_torch.utils.device import float32_precision, resolve_device

#: the seed of the weights drawn when the zoo holds no TextFuseNet tree
SEED = 0
#: the zoo ladder: (tree, config), first found wins
ZOO_LADDER = (("textfusenet-s2-synth", TextFuseNetConfig.synth_s2),
              ("textfusenet-synth", TextFuseNetConfig.synth))


@torch.no_grad()
def tfn_detect(model: TextFuseNet, page_u8: torch.Tensor, word_threshold: float,
               low_text: float, char_threshold: float) -> Dict[str, torch.Tensor]:
    """[H, W, 3] uint8 page -> the JAX ``_tfn_detect_jit``'s dict: refined
    ``boxes`` [K, 4] (stride-4 grid), ``heat_boxes``, fused ``scores``,
    ``heat_scores``, ``areas`` in stride-4 cells, ``valid``, ``char_boxes``,
    ``char_valid`` and the ``seg`` map."""
    cfg = model.cfg
    with record_function("marie.detect"), float32_precision(False):
        out = model.dense(normalize_page(page_u8)[None])
        word_region = out["word"][0, ..., 0]
        char_map = out["char"][0, ..., 0]
        # the maps are at head_stride; the fuse module pools stride-4 P3
        to_p3 = cfg.head_stride / 4.0
        with record_function("marie.cc"):
            wstats = component_boxes_runs_cc(word_region > low_text, word_region,
                                             max_components=cfg.max_words,
                                             max_runs_per_row=64)
            cstats = component_boxes(connected_components(char_map > char_threshold),
                                     char_map, max_components=cfg.max_chars)
        word_valid = wstats["valid"] & (wstats["scores"] >= word_threshold)
        score, refined = model.fuse(
            out["p3"][0], out["seg_feat"][0], wstats["boxes"] * to_p3, word_valid,
            cstats["boxes"] * to_p3, cstats["valid"])
    return {
        "boxes": refined,
        "heat_boxes": wstats["boxes"] * to_p3,
        "scores": score,
        "heat_scores": wstats["scores"],
        "areas": wstats["areas"] * (to_p3 * to_p3),
        "valid": word_valid,
        "char_boxes": cstats["boxes"],
        "char_valid": cstats["valid"],
        "seg": torch.sigmoid(out["seg_logits"][0, ..., 0]),
    }


class BoxProcessorTextFuseNet(BoxProcessor):
    """The multi-branch fusion detector with the shared box pipeline (the
    JAX package's ``BoxProcessorTextFuseNet``), on ``device`` (the card
    unless the caller asks for the CPU).

    Without ``config`` and ``variables`` the zoo's
    ``textfusenet-s2-synth``, then ``textfusenet-synth`` (``torch_zoo/``)
    are tried; without either ``TextFuseNetConfig.synth()`` is built
    with weights from seed :data:`SEED` (``zoo_name`` None).
    ``variables`` is a flax-layout numpy tree."""

    #: the zoo tree the weights came from (None: passed in or seeded)
    zoo_name: Optional[str] = None

    def __init__(
        self,
        config: Optional[TextFuseNetConfig] = None,
        variables=None,
        word_threshold: float = 0.6,
        low_text: float = 0.6,
        char_threshold: float = 0.5,
        fuse_threshold: float = 0.5,
        min_area: int = 4,
        page_hw: Tuple[int, int] = (1024, 768),
        bucket_spec: Optional[BucketSpec] = None,
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
        self.config = config or TextFuseNetConfig.synth()
        self.word_threshold = word_threshold
        self.low_text = low_text
        self.char_threshold = char_threshold
        self.fuse_threshold = fuse_threshold
        self.min_area = min_area
        self.buckets = bucket_spec or BucketSpec(shapes=(tuple(page_hw),))
        if variables is None:
            variables = init_flax_layout(self.config, SEED)
        self.model = load_model(self.config, variables, self.device)

    def detect_words(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        h, w = image.shape[:2]
        page_dev, scale = fit_page(image, self.buckets, self.device)
        stats = tfn_detect(self.model, page_dev, self.word_threshold, self.low_text,
                           self.char_threshold)
        stats = {k: v.cpu().numpy() for k, v in stats.items()}
        keep = (
            stats["valid"]
            & (stats["scores"] >= self.fuse_threshold)
            & (stats["areas"] >= self.min_area)
        )
        # the JAX processor scales by 4 whatever the head stride: the
        # refined boxes are on the stride-4 grid
        boxes = stats["boxes"][keep] * 4.0 / scale
        # geometric mean of the heatmap and fused confidences
        scores = (stats["scores"][keep] * stats["heat_scores"][keep]) ** 0.5
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
        return xywh[ok], scores[ok]
