"""What the trainers share: the starting module and the step loop.

:func:`init_module` builds a trainable module from the flax-default draw
of a seed (:func:`registry.convert.init_flax_defaults`), overlaid with a
given flax-layout tree.  :class:`StepTrainer` runs one optimiser step of a
loss: forward and backward in float32 without TF32 (``utils/device.py::
float32_precision``, as the float32 engines run; TF32 would move the
card's gradients from the CPU's by ~1e-3), K2 and its gradient counted on
the ``"train"`` launch path, then :class:`~marie_tpu_torch.train.optim.
AdamW` over every parameter (or the tensors a trainer names), with optax's
global-norm clip first where the trainer asks for it.
"""

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch

from marie_tpu_torch.ops.kernels._build import launch_path
from marie_tpu_torch.registry.convert import build_model, from_flax, init_flax_defaults
from marie_tpu_torch.train.optim import AdamW
from marie_tpu_torch.utils.device import float32_precision, resolve_device


def _overlay(base, top):
    """``base`` with every leaf that ``top`` has replaced by ``top``'s."""
    out = dict(base)
    for k, v in top.items():
        out[k] = _overlay(base[k], v) if isinstance(v, dict) and k in base else v
    return out


def init_module(config, head: Optional[str], seed: int, init_params=None, device="cuda"):
    """The port's module for ``config`` (and ``head``) on ``device``,
    trainable, from the flax-default draw of ``seed`` (its BatchNorm
    statistics too) overlaid with ``init_params`` (a flax-layout tree:
    variables, or a bare params tree) where given."""
    tree = init_flax_defaults(config, seed, head)
    if init_params is not None:
        top = init_params if "params" in init_params else {"params": init_params}
        tree = _overlay(tree, top)
    model = from_flax(tree, build_model(config, head))
    return model.to(resolve_device(device)).requires_grad_(True)


class StepTrainer:
    """The step loop shared by the trainers: ``loss_fn(batch) -> loss``
    (a 0-d tensor, with its gradient), AdamW over every parameter of
    ``model``, each step under float32 matmuls and the ``"train"`` launch
    path.  ``step(batch)`` returns the detached loss (and whatever else
    ``loss_fn`` returns, detached) and reads nothing back."""

    def __init__(self, model: torch.nn.Module, loss_fn, schedule, weight_decay: float,
                 clip_norm: Optional[float] = None, params=None):
        self.loss_fn = loss_fn
        self.opt = AdamW(model.parameters() if params is None else params, schedule,
                         weight_decay=weight_decay, clip_norm=clip_norm)
        self.steps = 0
        self.seconds = 0.0

    def step(self, *batch):
        self.opt.zero_grad()
        with float32_precision(False), launch_path("train"):
            out = self.loss_fn(*batch)
            loss = out[0] if isinstance(out, tuple) else out
            loss.backward()
            self.opt.step()
        self.steps += 1
        if isinstance(out, tuple):
            return tuple(o.detach() for o in out)
        return loss.detach()

    @contextlib.contextmanager
    def timed(self, device: torch.device) -> Iterator[None]:
        """Adds the block's wall time, synchronised, to ``seconds``."""

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync()
            self.seconds += time.perf_counter() - t0

    def timing(self) -> Dict[str, float]:
        return {"steps": self.steps, "train_s": self.seconds,
                "ms_per_step": self.seconds / max(self.steps, 1) * 1e3,
                "steps_per_s": self.steps / self.seconds if self.seconds else 0.0}
