"""Learned template matching over the CRAFT trunk (port of
``marie_tpu/components/template_matching/dim_matcher.py``).

* :class:`DIMTemplateMatcher`: cosine similarity of L2-normalised
  ``stage3`` feature grids (stride 4); the template's feature patch is the
  kernel of one convolution and a box-filter convolution gives the local
  norms, so the map is exact cosine similarity.
* :class:`VQNNFTemplateMatcher`: a small k-means codebook of the
  template's features (host numpy, a copy of the JAX version's); page and
  template cells take their nearest codeword and the map counts the
  codeword agreements under the template (a nearest-neighbour-field vote).

The trunk is ``CraftConfig.base()`` in float32: ``torch_zoo/craft-synth``
when the zoo has it, else drawn from ``SEED`` (``trained`` says which).
Convolutions and the codeword einsum run in full float32 on the card.
"""

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from marie_tpu_torch.components.template_matching.base import (
    BaseTemplateMatcher,
    TemplateMatchResult,
    top_peaks,
)
from marie_tpu_torch.models.configs import CraftConfig
from marie_tpu_torch.preprocess.ops import normalize_page
from marie_tpu_torch.utils.device import float32_precision, resolve_device

#: the zoo tree of the trunk
ZOO_TREE = "craft-synth"
#: the seed of the trunk drawn when the zoo lacks the tree
SEED = 0


def trunk_features(model, image_u8: torch.Tensor, layer: str = "stage3") -> torch.Tensor:
    """[H, W, 3] uint8 on the model's device -> the L2-normalised feature
    grid [H/s, W/s, C] of the named CRAFT stage (``_trunk_features``)."""
    rgb = normalize_page(image_u8)
    dtype = next(model.parameters()).dtype
    with float32_precision(False):
        grid = model.trunk(rgb[None].to(dtype), layer)[0].to(torch.float32)
    norm = torch.sqrt(torch.sum(grid * grid, dim=-1, keepdim=True))
    return grid / torch.clamp(norm, min=1e-6)


def _box_sum(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """VALID sums of [h, w] over every (th, tw) window."""
    ones = torch.ones((1, 1, th, tw), dtype=torch.float32, device=x.device)
    return F.conv2d(x[None, None], ones)[0, 0]


def cosine_map(page_feats: torch.Tensor, tpl_feats: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of a template feature patch [th, tw, C] at every
    VALID position of a page grid [h, w, C] (``_cosine_match_jit``)."""
    th, tw = tpl_feats.shape[:2]
    t_norm = torch.sqrt(torch.sum(tpl_feats * tpl_feats) + 1e-6)
    with float32_precision(False):
        corr = F.conv2d(page_feats.permute(2, 0, 1)[None],
                        tpl_feats.permute(2, 0, 1)[None])[0, 0]
        local = _box_sum(torch.sum(page_feats * page_feats, dim=-1), th, tw)
    return corr / (torch.sqrt(torch.clamp(local, min=1e-6)) * t_norm)


def vq_map(page_onehot: torch.Tensor, tpl_onehot: torch.Tensor) -> torch.Tensor:
    """The share of a template's cells [th, tw, K] whose codeword the page
    grid [h, w, K] repeats, at every VALID position (``_vq_match_jit``):
    exact integer hit counts times float32(1 / (th * tw))."""
    th, tw = tpl_onehot.shape[:2]
    with float32_precision(False):
        hits = F.conv2d(page_onehot.permute(2, 0, 1)[None],
                        tpl_onehot.permute(2, 0, 1)[None])[0, 0]
    return hits * (1.0 / float(th * tw))


def _kmeans(feats: np.ndarray, k: int, iters: int = 8, seed: int = 0):
    """Tiny host-side k-means for the template codebook. feats [N, C]."""
    rng = np.random.default_rng(seed)
    k = min(k, len(feats))
    centers = feats[rng.choice(len(feats), size=k, replace=False)].copy()
    for _ in range(iters):
        d = ((feats[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(k):
            sel = feats[assign == j]
            if len(sel):
                centers[j] = sel.mean(0)
    return centers


class _TrunkMatcher(BaseTemplateMatcher):
    """Shared trunk-feature plumbing of the learned matchers."""

    stride = 4  # the stage3 grid

    def __init__(self, variables=None, config: Optional[CraftConfig] = None,
                 max_peaks: int = 32, device="cuda", **kwargs):
        from marie_tpu_torch.registry.convert import init_flax_layout, load_model

        super().__init__(**kwargs)
        self.device = resolve_device(device)
        self.trained = variables is not None
        if variables is None and config is None:
            from marie_tpu_torch.registry.zoo import zoo_params

            variables = zoo_params(ZOO_TREE)
            self.trained = variables is not None
        self.config = config or CraftConfig.base()
        if variables is None:
            variables = init_flax_layout(self.config, SEED)
        self.model = load_model(self.config, variables, self.device)
        self.max_peaks = max_peaks

    def _grid(self, image: np.ndarray) -> torch.Tensor:
        img = np.asarray(image)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        # pad to the trunk's stride multiple (16 through stage3's pools)
        h, w = img.shape[:2]
        ph = (h + 15) // 16 * 16
        pw = (w + 15) // 16 * 16
        if (ph, pw) != (h, w):
            pad = np.full((ph, pw, 3), 255, np.uint8)
            pad[:h, :w] = img
            img = pad
        with torch.inference_mode():
            return trunk_features(self.model, torch.from_numpy(np.ascontiguousarray(img))
                                  .to(self.device))

    def _emit(self, boxes, scores, keep, threshold, limit, label, fi, out):
        picked = 0
        for box, score, k in zip(boxes, scores, keep):
            if not k or score < threshold or picked >= limit:
                continue
            x0, y0, x1, y1 = (float(v) * self.stride for v in box)
            out.append(TemplateMatchResult(
                bbox=[int(x0), int(y0), int(x1 - x0), int(y1 - y0)], label=label,
                score=float(score), similarity=float(score), frame_index=fi))
            picked += 1


class DIMTemplateMatcher(_TrunkMatcher):
    def match(self, frames: Sequence[np.ndarray], score_threshold: float = 0.6,
              max_matches_per_template: int = 5) -> List[TemplateMatchResult]:
        out: List[TemplateMatchResult] = []
        tpl_feats = [(tpl, self._grid(tpl["image"])) for tpl in self._templates]
        for fi, frame in enumerate(frames):
            page = self._grid(frame)
            for tpl, tf in tpl_feats:
                th, tw = tf.shape[:2]
                if th > page.shape[0] or tw > page.shape[1]:
                    continue
                with torch.inference_mode():
                    peaks = top_peaks(cosine_map(page, tf), th, tw, self.max_peaks)
                self._emit(*peaks, score_threshold, max_matches_per_template,
                           tpl["label"], fi, out)
        return out


class VQNNFTemplateMatcher(_TrunkMatcher):
    def __init__(self, codebook_size: int = 16, **kwargs):
        super().__init__(**kwargs)
        self.codebook_size = codebook_size

    def _codebook(self, tpl_grid: np.ndarray) -> np.ndarray:
        return _kmeans(tpl_grid.reshape(-1, tpl_grid.shape[-1]), self.codebook_size)

    @staticmethod
    def _assign_onehot(grid: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        """One-hot [h, w, K] of each cell's nearest codeword (squared
        distance expanded as |g|^2 - 2 g.c + |c|^2; the first minimum)."""
        with float32_precision(False):
            dots = torch.einsum("hwc,kc->hwk", grid, centers)
        d = (torch.sum(grid * grid, -1, keepdim=True) - 2.0 * dots
             + torch.sum(centers * centers, -1)[None, None])
        return F.one_hot(torch.argmin(d, -1), centers.shape[0]).to(torch.float32)

    def match(self, frames: Sequence[np.ndarray], score_threshold: float = 0.5,
              max_matches_per_template: int = 5) -> List[TemplateMatchResult]:
        out: List[TemplateMatchResult] = []
        prepped = []
        for tpl in self._templates:
            tg = self._grid(tpl["image"])
            centers = torch.from_numpy(self._codebook(tg.cpu().numpy())).to(self.device)
            with torch.inference_mode():
                prepped.append((tpl, centers, self._assign_onehot(tg, centers)))
        for fi, frame in enumerate(frames):
            page = self._grid(frame)
            for tpl, centers, tpl_onehot in prepped:
                th, tw = tpl_onehot.shape[:2]
                if th > page.shape[0] or tw > page.shape[1]:
                    continue
                with torch.inference_mode():
                    page_onehot = self._assign_onehot(page, centers)
                    peaks = top_peaks(vq_map(page_onehot, tpl_onehot), th, tw, self.max_peaks)
                self._emit(*peaks, score_threshold, max_matches_per_template,
                           tpl["label"], fi, out)
        return out
