"""Document boundary registration: find the page, deskew and align it to
the frame (port of ``marie_tpu/components/document_registration/
boundary.py``).

Two paths, as in the JAX version:

* the model path (:class:`~marie_tpu_torch.models.boundary.BoundaryNet`
  regresses the page quad on a 192x256 copy, optionally snapped to the
  bright page's silhouette by :func:`refine_quad_corners`, and
  ``fit_to_page`` warps the quad onto the full frame);
* the weight-free deskew: the ink mask is rotated for every candidate
  angle and the angle whose row profile has the largest variance wins;
  the page is rotated back, its ink extent is the box, and ``fit_to_page``
  stretches the box onto the frame.

The device does the pixel work (the resize, the network, the angle sweep
and the warps).  The host does what is small or exact: the angle grid and
its cosines (numpy's float32 ``cos``/``sin`` give XLA's bits on the
grid, torch's do not), the 8x8 homography solve, the silhouette snap and
the final ``fit_to_page`` resize of the deskew path
(``preprocess/resize.py::resize_linear_u8``, cv2's ``INTER_LINEAR`` in
numpy).  Grid coordinates are rounded as XLA's CPU backend contracts the
JAX version's multiply-adds.
"""

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.models.configs import BoundaryConfig
from marie_tpu_torch.preprocess.ops import _bilinear_hwc, fma, otsu_binarize, to_grayscale
from marie_tpu_torch.utils.device import float32_precision, resolve_device

#: the zoo tree the model path loads when given none
ZOO_TREE = "boundary-synth"
#: the seed of the full-width regressor drawn when the zoo lacks the tree
SEED = 0
#: pixels the sweep rotates at once on the device (angles x page
#: pixels): 8 angles of a 1024x768 page, fewer of a larger one, so that
#: the sweep's temporaries stay near 250 MiB whatever the page's size
SWEEP_PIXELS = 8 * 1024 * 768


@dataclasses.dataclass
class DocumentBoundaryPrediction:
    detected: bool
    box: List[int]  # xywh content boundary
    angle: float  # skew degrees (CCW positive)
    score: float
    aligned: Optional[np.ndarray] = None  # registered page

    def to_dict(self):
        return {
            "detected": self.detected,
            "box": self.box,
            "angle": self.angle,
            "score": self.score,
        }


def angle_grid(max_angle_deg: float, num_angles: int) -> np.ndarray:
    """The sweep's angles in radians, float32: ``jnp.linspace(-a, a, n) *
    (pi / 180)`` as XLA computes it (``-a * (1 - i * r) + i * (a * r)``
    with r = float32(1 / (n - 1)), the end point appended)."""
    f32 = np.float32
    a = f32(max_angle_deg)
    if num_angles == 1:
        lin = np.asarray([-a], f32)
    else:
        r = f32(1.0 / (num_angles - 1))
        i = np.arange(num_angles - 1, dtype=f32)
        lin = np.concatenate([(-a) * (f32(1) - i * r) + i * (a * r), [a]]).astype(f32)
    return (lin * f32(np.pi / 180.0)).astype(f32)


def _rotate_coords(h: int, w: int, cos: torch.Tensor, sin: torch.Tensor,
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampling grid [A, H, W] for rotating around the page centre by the
    angles whose float32 cosines and sines are ``cos``, ``sin`` [A], with
    dy = y - cy, dx = x - cx: ``sy = cy + dy c - dx s``, ``sx = cx + dy s
    + dx c``, rounded as XLA contracts them in the sweep and the align
    programs: ``fma(-dx, s, fma(dy, c, cy))``, ``fma(dx, c, fma(dy, s,
    cx))``."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dy = (torch.arange(h, dtype=torch.float32, device=device) - cy)[None, :, None]
    dx = (torch.arange(w, dtype=torch.float32, device=device) - cx)[None, None, :]
    c, s = cos[:, None, None], sin[:, None, None]
    y_part = fma(dy, c, torch.tensor(cy, dtype=torch.float32, device=device))
    x_part = fma(dy, s, torch.tensor(cx, dtype=torch.float32, device=device))
    return fma(-dx, s, y_part), fma(dx, c, x_part)


def _trig(angles: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    angles = np.asarray(angles, np.float32)
    return (torch.from_numpy(np.cos(angles)).to(device),
            torch.from_numpy(np.sin(angles)).to(device))


def deskew_sweep(gray: torch.Tensor, angles: np.ndarray,
                 chunk: Optional[int] = None) -> Tuple[int, float]:
    """The angle sweep (``_deskew_jit``): gray [H, W] float32 in [0, 1] on
    the device -> (index of the best angle, its score).  Each angle's
    nearest-neighbour rotation of the Otsu ink mask is summed along rows;
    the variance of that profile (population) scores the angle; the first
    maximum wins, scored against the mean variance.  ``chunk`` angles are
    rotated at once (by default as many as ``SWEEP_PIXELS`` allows)."""
    h, w = gray.shape
    dev = gray.device
    chunk = chunk or max(1, SWEEP_PIXELS // (h * w))
    ink = otsu_binarize(gray).to(torch.float32).reshape(-1)
    cos, sin = _trig(angles, dev)
    variances = []
    for k in range(0, len(angles), chunk):
        sy, sx = _rotate_coords(h, w, cos[k:k + chunk], sin[k:k + chunk], dev)
        y0 = torch.clamp(torch.round(sy).to(torch.int64), 0, h - 1)
        x0 = torch.clamp(torch.round(sx).to(torch.int64), 0, w - 1)
        rows = ink[y0 * w + x0].sum(dim=2)  # [A, H], exact integers
        mean = rows.sum(dim=1, keepdim=True) * (1.0 / h)
        variances.append(((rows - mean) ** 2).sum(dim=1) * (1.0 / h))
    var = torch.cat(variances)
    best = int(torch.argmax(var))  # the first maximum
    score = var[best] / torch.clamp(var.sum() * (1.0 / len(angles)), min=1e-6)
    return best, float(score)


def rotate_page(page: torch.Tensor, angle_rad) -> torch.Tensor:
    """Rotate a uint8 page [H, W, C] by ``-angle_rad`` (bilinear, white
    outside the page; ``_align_jit``); uint8 on the page's device."""
    h, w = page.shape[:2]
    cos, sin = _trig(np.asarray([-np.float32(angle_rad)], np.float32), page.device)
    sy, sx = _rotate_coords(h, w, cos, sin, page.device)
    sy, sx = sy[0], sx[0]
    out = _bilinear_hwc(page.to(torch.float32), sy, sx)
    oob = (sy < 0) | (sy > h - 1) | (sx < 0) | (sx > w - 1)
    out = torch.where(oob[..., None], torch.full_like(out, 255.0), out)
    return torch.clamp(out, 0, 255).to(torch.uint8)


def _gray(page_u8: torch.Tensor) -> torch.Tensor:
    """``to_grayscale(page / 255.0)`` with the JAX version's eager (true)
    division."""
    return to_grayscale(page_u8.to(torch.float32) / 255.0)


def refine_quad_corners(
    frame: np.ndarray,
    pred_quad: np.ndarray,
    max_shift: float = 80.0,
) -> np.ndarray:
    """Snap a regressed page quad to the bright-page mask's extreme points
    (host numpy, a copy of the JAX version's).

    The physical page is (near-)white against a darker background, so its
    silhouette is the dominant bright region and each corner is the mask
    pixel extremising one of four linear functionals (tl: min x+y, tr: max
    x-y, br: max x+y, bl: min x-y; exact for |skew| < 45 degrees).  A
    refined corner is taken only within ``max_shift`` px of the
    regression; a frame without contrast or without a bright region keeps
    the regression."""
    gray = frame.mean(axis=-1) if frame.ndim == 3 else frame.astype(np.float32)
    gray = gray.astype(np.float32)
    if gray.std() < 10.0:
        return pred_quad
    # Otsu threshold between background and paper
    hist, edges = np.histogram(gray, bins=64, range=(0.0, 255.0))
    p = hist.astype(np.float64) / max(hist.sum(), 1)
    centers = (edges[:-1] + edges[1:]) / 2.0
    w0 = np.cumsum(p)
    m = np.cumsum(p * centers)
    mt = m[-1]
    w1 = 1.0 - w0
    valid = (w0 > 1e-6) & (w1 > 1e-6)
    between = np.where(valid, (mt * w0 - m) ** 2 / np.maximum(w0 * w1, 1e-12), 0.0)
    thr = centers[int(np.argmax(between))]
    mask = gray > thr
    if not mask.any() or mask.mean() < 0.05:
        return pred_quad
    ys, xs = np.nonzero(mask)
    xs = xs.astype(np.float32)
    ys = ys.astype(np.float32)
    cand = np.stack([
        np.stack([xs[i], ys[i]])
        for i in (
            np.argmin(xs + ys),  # tl
            np.argmax(xs - ys),  # tr
            np.argmax(xs + ys),  # br
            np.argmin(xs - ys),  # bl
        )
    ])
    shift = np.linalg.norm(cand - pred_quad, axis=-1)
    return np.where((shift <= max_shift)[:, None], cand, pred_quad)


class DocumentBoundaryRegistration:
    """``register(frame)`` -> :class:`DocumentBoundaryPrediction`;
    ``run(frame)`` -> ``{"meta": ..., "aligned": ...}``, the extract
    pipeline's boundary stage.

    With ``use_model`` (default) and no ``model_variables``, the regressor
    is ``torch_zoo/boundary-synth`` when the zoo has it, else
    ``BoundaryConfig()`` drawn from ``SEED`` (``trained`` says which).
    ``use_model=False`` takes the weight-free deskew.  Runs on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(
        self,
        max_skew_deg: float = 7.0,
        num_angles: int = 57,
        registration_method: str = "fit_to_page",
        boundary_fn: Optional[Callable] = None,
        model_variables=None,
        model_config: Optional[BoundaryConfig] = None,
        use_model: bool = True,
        quad_margin: float = 0.015,
        edge_refine: bool = True,
        device="cuda",
    ):
        self.logger = MarieLogger("BoundaryRegistration")
        self.device = resolve_device(device)
        self.max_skew_deg = max_skew_deg
        self.num_angles = num_angles
        self.registration_method = registration_method
        self.quad_margin = quad_margin
        self.edge_refine = edge_refine
        self.boundary_fn = boundary_fn
        self.model = None
        self.model_config = None
        self.trained = False
        if use_model:
            from marie_tpu_torch.registry.convert import init_flax_layout, load_model

            self.trained = model_variables is not None
            if model_variables is None:
                from marie_tpu_torch.registry.zoo import zoo_params

                model_variables = zoo_params(ZOO_TREE)
                self.trained = model_variables is not None
                if model_variables is not None:
                    model_config = BoundaryConfig()
            self.model_config = model_config or BoundaryConfig()
            if model_variables is None:
                model_variables = init_flax_layout(self.model_config, SEED)
            self.model = load_model(self.model_config, model_variables, self.device)

    def run(self, frame: np.ndarray) -> dict:
        pred = self.register(frame)
        return {"meta": pred.to_dict(), "aligned": pred.aligned}

    def register(self, frame: np.ndarray) -> DocumentBoundaryPrediction:
        frame = np.asarray(frame)
        if frame.ndim == 2:
            frame = np.stack([frame] * 3, -1)
        if self.model is not None:
            return self._register_model(frame)
        return self._register_deskew(frame)

    def corners(self, frame: np.ndarray) -> np.ndarray:
        """The regressor's quad [4, 2] (xy, frame pixels, float32) of an
        [H, W, 3] uint8 frame: the frame resized to the model's input as
        ``jax.image.resize`` resizes (antialiased, ``preprocess/ops.py::
        resize_linear``), divided by 255, the network in float32."""
        from marie_tpu_torch.preprocess.ops import resize_linear

        h, w = frame.shape[:2]
        ih, iw = self.model_config.input_hw
        page = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)
        with torch.inference_mode(), float32_precision(False):
            small = resize_linear(page[None].to(torch.float32), ih, iw) / 255.0
            pred = self.model(small)[0].cpu().numpy()
        return pred.reshape(4, 2) * np.asarray([w - 1.0, h - 1.0], np.float32)

    def _register_model(self, frame: np.ndarray) -> DocumentBoundaryPrediction:
        """Regress the page quad at model resolution, then ``fit_to_page``:
        one full-resolution perspective warp."""
        from marie_tpu_torch.models.boundary import warp_quad_to_page

        h, w = frame.shape[:2]
        corners = self.corners(frame)
        refined = False
        if self.edge_refine:
            snapped = refine_quad_corners(frame, corners)
            refined = bool(np.any(snapped != corners))
            corners = snapped
        # skew angle from the top edge (tl -> tr)
        dx, dy = corners[1] - corners[0]
        angle_deg = float(np.degrees(np.arctan2(-dy, dx)))
        x0, y0 = corners.min(axis=0)
        x1, y1 = corners.max(axis=0)
        box = [int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)]
        aligned = frame
        if self.registration_method == "fit_to_page":
            # expand the quad outward before warping: the regression's
            # residual corner error otherwise over-crops; snapped corners
            # are the outermost page pixels and need no margin
            margin = 0.0 if refined else self.quad_margin
            centroid = corners.mean(axis=0, keepdims=True)
            expanded = centroid + (corners - centroid) * (1.0 + margin)
            aligned = warp_quad_to_page(frame, expanded, h, w, device=self.device).cpu().numpy()
        # confidence: the quad's area fraction (degenerate quads score low)
        area = 0.5 * abs(np.dot(corners[[1, 2, 3, 0], 0] - corners[:, 0],
                                corners[[1, 2, 3, 0], 1] + corners[:, 1]))
        return DocumentBoundaryPrediction(
            detected=area > 0.05 * h * w,
            box=box,
            angle=round(angle_deg, 3),
            score=float(area / (h * w)),
            aligned=aligned,
        )

    def _register_deskew(self, frame: np.ndarray) -> DocumentBoundaryPrediction:
        from marie_tpu_torch.preprocess.resize import resize_linear_u8

        angles = angle_grid(self.max_skew_deg, self.num_angles)
        with torch.inference_mode():
            page = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)
            best, score = deskew_sweep(_gray(page), angles)
            angle_rad = angles[best]
            aligned_dev = rotate_page(page, angle_rad)
            box = None
            if self.boundary_fn is None:
                # content boundary: the ink extent of the aligned page
                ink = otsu_binarize(_gray(aligned_dev))
                rows, cols = ink.any(dim=1), ink.any(dim=0)
                if bool(rows.any()):
                    ys = torch.nonzero(rows)[:, 0]
                    xs = torch.nonzero(cols)[:, 0]
                    y0, y1, x0, x1 = (int(v) for v in torch.stack(
                        [ys.min(), ys.max(), xs.min(), xs.max()]).cpu())
                    box = [x0, y0, x1 - x0 + 1, y1 - y0 + 1]
            aligned = aligned_dev.cpu().numpy()
        angle_deg = float(angle_rad) * 180.0 / np.pi
        if self.boundary_fn is not None:
            box = self.boundary_fn(aligned)
        elif box is None:
            h, w = aligned.shape[:2]
            box = [0, 0, w, h]
        if self.registration_method == "fit_to_page":
            h, w = aligned.shape[:2]
            x, y, bw, bh = box
            crop = np.ascontiguousarray(aligned[y:y + bh, x:x + bw])
            aligned = resize_linear_u8(crop, (w, h))
        return DocumentBoundaryPrediction(
            detected=True,
            box=box,
            angle=round(angle_deg, 3),
            score=float(score),
            aligned=aligned,
        )
