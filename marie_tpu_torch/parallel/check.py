"""What two float32 runs of the training step must agree on.

A sharded step and a one-rank step (or the port's step and the JAX
package's) sum their gradients in other orders, so their gradients agree
to a limit and not exactly.  Through AdamW that limit decides which
parameters they must agree on.  :func:`step_masks` gives both decisions.
The tests and ``chip_smoke.py`` use them; the training path does not."""

import itertools
from typing import Dict, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _adam_moves(grads, b1=0.9, b2=0.999, eps=1e-8):
    """The sum of AdamW's normalised updates over the steps of ``grads``
    (optax's, without the weight decay's term)."""
    mu = nu = total = 0.0
    for t, g in enumerate(grads, start=1):
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        total = total + (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t)) + eps)
    return total


def _flat(tree, prefix=()):
    """(path, leaf) of a nested dict's leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _float64(x) -> torch.Tensor:
    return x.detach().to(torch.float64) if torch.is_tensor(x) else torch.as_tensor(
        np.asarray(x, np.float64))


def step_masks(grad_trees, params, tol: float, noise: float = 1e-5, lr: float = 1e-4,
               zero_floor: float = 1e-6) -> Tuple[Dict[Path, bool], Dict[Path, torch.Tensor]]:
    """(live, resolved) of a run of AdamW (learning rate ``lr``) that took
    the steps of ``grad_trees`` (each step's gradient tree) to ``params``.

    ``live``: {leaf path: bool}, whether the leaf's largest gradient is at
    least ``zero_floor`` of the tree's largest.  A leaf below it has a
    gradient that is zero in exact arithmetic (a key bias's: softmax does
    not see a shift of every logit), and what float32 holds there is
    noise: its gradients are not compared.

    ``resolved``: {leaf path: bool mask} of a live leaf's elements that
    the run determines to ``tol`` of the leaf's largest value: where a
    gradient error of ``noise`` of the leaf's largest gradient, of either
    sign at each step, moves the parameter by at most half of that.  Where
    two runs' gradients agree to ``noise``, their parameters can differ by
    more only outside the mask; there the update divides the error by a
    moment near zero (steps whose gradients cancel, or a gradient near
    zero), and where the parameter ends is rounding noise.

    Trees are nested dicts (or flat ``{name: leaf}``) of numpy arrays or
    tensors; the masks are on the leaves' devices."""
    steps = [dict(_flat(g)) for g in grad_trees]
    top = max(float(_float64(x).abs().max()) for s in steps for x in s.values())
    live, resolved = {}, {}
    for path, value in _flat(params):
        g = [_float64(s[path]) for s in steps]
        largest = max(float(x.abs().max()) for x in g)
        live[path] = largest >= zero_floor * top
        if not live[path]:
            resolved[path] = torch.zeros(g[0].shape, dtype=torch.bool, device=g[0].device)
            continue
        err = noise * largest
        base = _adam_moves(g)
        worst = torch.zeros_like(base)
        for signs in itertools.product((-1.0, 1.0), repeat=len(g)):
            moved = _adam_moves([x + sgn * err for x, sgn in zip(g, signs)])
            worst = torch.maximum(worst, (moved - base).abs())
        resolved[path] = lr * worst <= 0.5 * tol * float(_float64(value).abs().max())
    return live, resolved


def resolved_share(live: Dict[Path, bool], resolved: Dict[Path, torch.Tensor]) -> float:
    """The share of the live leaves' elements that resolve."""
    total = sum(m.numel() for p, m in resolved.items() if live[p])
    return sum(int(m.sum()) for p, m in resolved.items() if live[p]) / max(total, 1)
