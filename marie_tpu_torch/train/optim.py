"""The optax pieces the trainers use, in PyTorch.

* :func:`warmup_cosine_decay_schedule`: optax's schedule of the same name
  and meaning.  ``decay_steps`` counts the warmup (the cosine runs for
  ``decay_steps - warmup_steps`` steps after it), and step ``k`` of a
  trainer uses ``schedule(k)`` (optax reads the schedule at the count
  before it increments).  Values are float32 computed in optax's order of
  operations; the cosine is the correctly rounded float32 cosine, where
  XLA's float32 ``cos`` is off it by an ulp at some arguments, so values
  agree with optax's to ~3e-8 of the peak.
* :class:`AdamW`: ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8,
  ``eps_root`` 0): Adam's moments with bias correction, then the decoupled
  weight decay ``weight_decay * p`` added to *every* leaf, then the step
  ``-lr(count) * update``.  A parameter whose ``.grad`` is None (a leaf
  the loss does not reach, such as ``vis_pos`` when a trainer passes no
  image) steps with a zero gradient, so it decays as optax decays it
  (``torch.optim`` would skip it).  The arithmetic runs on the card as
  multi-tensor ``torch._foreach_*`` operations, in place where optax's
  arithmetic allows, with the step count, the learning rate and the bias
  corrections as host scalars: no host sync a step.  The bias corrections
  are computed in the parameters' float type, as optax computes them
  (float32, or float64 for float64 parameters under ``jax_enable_x64``).
* ``clip_norm``: ``optax.chain(optax.clip_by_global_norm(clip_norm),
  optax.adamw(...))``, as the OCR trainers chain them: where the global
  norm of the gradients (every leaf's, zeros for a leaf without one)
  reaches ``clip_norm``, each gradient becomes ``g / norm * clip_norm``
  before Adam reads it; the norm stays on the card.
* :func:`softmax_cross_entropy_with_integer_labels`: optax's, written the
  same way (max-shifted log-sum-exp minus the label's logit).
"""

import math
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]


def _linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: np.float32(init_value)

    def schedule(count: int):
        count = min(max(count, 0), transition_steps)
        frac = np.float32(1) - np.float32(count) / np.float32(transition_steps)
        return np.float32(init_value - end_value) * frac + np.float32(end_value)

    return schedule


def _cosine(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int):
        count = np.float32(min(count, decay_steps))
        arg = np.float32(math.pi) * count / np.float32(decay_steps)
        cosine = np.float32(0.5) * (np.float32(1) + np.float32(math.cos(float(arg))))
        decayed = np.float32(1 - alpha) * cosine + np.float32(alpha)
        return np.float32(init_value) * decayed

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule`` (exponent 1): a linear ramp
    from ``init_value`` to ``peak_value`` over ``warmup_steps``, then a
    cosine from ``peak_value`` to ``end_value`` that ends at step
    ``decay_steps`` (which counts the warmup) and stays there.  Returns
    ``schedule(count) -> np.float32``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = _linear(init_value, peak_value, warmup_steps)
    cosine = _cosine(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count: int):
        return warm(count) if count < warmup_steps else cosine(count - warmup_steps)

    return schedule


def softmax_cross_entropy_with_integer_labels(logits: torch.Tensor,
                                              labels: torch.Tensor) -> torch.Tensor:
    """Per-example cross entropy of ``logits [..., C]`` against integer
    ``labels [...]``: ``log(sum(exp(x - max))) - (x_label - max)`` with the
    max held constant, as optax computes it."""
    shifted = logits - logits.detach().amax(dim=-1, keepdim=True)
    label_logits = torch.gather(shifted, -1, labels.long()[..., None])[..., 0]
    return torch.log(torch.exp(shifted).sum(dim=-1)) - label_logits


class AdamW:
    """``optax.adamw(schedule, b1, b2, eps, weight_decay=...)`` over a list
    of parameters (every leaf steps, see the module note).  ``step()``
    reads each parameter's ``.grad``, updates the parameters in place and
    advances the count; ``zero_grad()`` sets the gradients to None."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
                 clip_norm: Optional[float] = None):
        self.params: List[torch.Tensor] = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.clip_norm = clip_norm
        self.count = 0
        with torch.no_grad():
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
        self._zeros = {}

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _grads(self) -> List[torch.Tensor]:
        out = []
        for i, p in enumerate(self.params):
            if p.grad is None:
                if i not in self._zeros:
                    self._zeros[i] = torch.zeros_like(p)
                out.append(self._zeros[i])
            else:
                out.append(p.grad)
        return out

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax's ``clip_by_global_norm``: ``g / norm * clip_norm`` where
        the norm reaches ``clip_norm`` (new tensors; ``.grad`` is kept)."""
        norm = torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())
        keep = norm < self.clip_norm
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        out = torch._foreach_div(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(out, torch.where(keep, one, one * self.clip_norm))
        return out

    @torch.no_grad()
    def step(self) -> None:
        grads = self._grads()
        if self.clip_norm is not None:
            grads = self._clip(grads)
        b1, b2 = self.b1, self.b2
        lr = float(self.schedule(self.count))
        self.count += 1
        real = np.float64 if self.params and self.params[0].dtype == torch.float64 else np.float32
        t = real(self.count)
        bc1 = float(real(1) - np.power(real(b1), t))
        bc2 = float(real(1) - np.power(real(b2), t))
        # mu = b1 mu + (1 - b1) g; nu = b2 nu + (1 - b2) g^2 (in place)
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        # u = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd p;  p += -lr u
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
