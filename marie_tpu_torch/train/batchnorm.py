"""flax's ``nn.BatchNorm`` in the two ways the OCR trainers use it, on the
port's ``nn.BatchNorm2d`` modules (whose parameters and buffers carry the
flax leaves: ``scale``/``bias`` and ``batch_stats`` ``mean``/``var``).

* :func:`use_batch_statistics` (the CRAFT trainer, ``train=True``): each
  forward normalises with the batch's own statistics, flax's fast
  variance ``max(0, mean(x^2) - mean(x)^2)`` (biased), and keeps them;
  :func:`update_running_statistics` then moves the running statistics as
  flax does, ``momentum * running + (1 - momentum) * batch`` with
  momentum 0.99 (``nn.BatchNorm2d`` would use 0.1 and the unbiased
  variance).
* :func:`train_running_statistics` (the CRNN trainer): the JAX trainer
  applies the model with ``train=False`` and steps every leaf of the
  variables, so the running mean and variance are normalisation
  constants that the loss differentiates and AdamW updates like any
  parameter.  They become leaves that require a gradient.

Both normalise as flax's ``_normalize`` does: ``(x - mean) * (rsqrt(var +
eps) * scale) + bias``.  :func:`restore` gives the modules back their own
forward.
"""

import functools
from typing import List

import torch
import torch.nn as nn

FLAX_MOMENTUM = 0.99


def batch_norms(model: nn.Module) -> List[nn.BatchNorm2d]:
    return [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]


def _normalize(bn: nn.BatchNorm2d, x: torch.Tensor, mean: torch.Tensor,
               var: torch.Tensor) -> torch.Tensor:
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[None, :, None, None]) * mul[None, :, None, None] + bn.bias[None, :, None, None]


def _batch_forward(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    bn.flax_batch_stats = (mean.detach(), var.detach())
    return _normalize(bn, x, mean, var)


def _running_forward(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    return _normalize(bn, x, bn.running_mean, bn.running_var)


def use_batch_statistics(model: nn.Module) -> None:
    """Every BatchNorm of ``model`` normalises with its batch's statistics
    (flax ``train=True``) until :func:`restore`."""
    for bn in batch_norms(model):
        bn.forward = functools.partial(_batch_forward, bn)


@torch.no_grad()
def update_running_statistics(model: nn.Module, momentum: float = FLAX_MOMENTUM) -> None:
    """flax's update of the running statistics from the last forward's
    batch statistics."""
    for bn in batch_norms(model):
        mean, var = bn.flax_batch_stats
        bn.running_mean.mul_(momentum).add_(mean, alpha=1.0 - momentum)
        bn.running_var.mul_(momentum).add_(var, alpha=1.0 - momentum)


def train_running_statistics(model: nn.Module) -> List[torch.Tensor]:
    """Every BatchNorm of ``model`` normalises with its running statistics,
    which require a gradient, until :func:`restore`; returns them (mean,
    var of each module) for the optimiser."""
    stats = []
    for bn in batch_norms(model):
        bn.forward = functools.partial(_running_forward, bn)
        bn.running_mean.requires_grad_(True)
        bn.running_var.requires_grad_(True)
        stats += [bn.running_mean, bn.running_var]
    return stats


def restore(model: nn.Module) -> None:
    """The BatchNorm modules' own forward again (eval mode reads the
    running statistics), their statistics plain buffers."""
    for bn in batch_norms(model):
        bn.__dict__.pop("forward", None)
        bn.__dict__.pop("flax_batch_stats", None)
        bn.running_mean.requires_grad_(False)
        bn.running_var.requires_grad_(False)
        bn.running_mean.grad = None
        bn.running_var.grad = None
