"""Collectives over one axis of a world :class:`~marie_tpu_torch.parallel.mesh.Mesh`
(the port's ``lax.psum`` / ``all_gather`` / ``all_to_all`` /
``ppermute``), and the two autograd functions of column-parallel
products.

Every helper takes tensors on the rank's own device (a tensor elsewhere
raises; nothing is copied quietly) and returns a new tensor.  On an axis
of one rank each is the identity.  On a gloo world whose ranks compute on
cards (``mesh.staged``: two ranks on one GPU, which NCCL refuses) each
collective copies its inputs to host memory, runs there, and copies the
result back, whether or not gloo has a CUDA form of it: one rule, stated,
instead of a per-operation switch.
"""

from typing import List

import torch

from marie_tpu_torch.parallel.mesh import Mesh


def _check(mesh: Mesh, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device != mesh.device:
            raise ValueError(f"a tensor on {t.device} in a world computing on {mesh.device}")


def _host(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous() if mesh.staged else t.detach().contiguous()


def _back(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return t.to(mesh.device) if mesh.staged else t


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over ``axis`` (``lax.psum``)."""
    import torch.distributed as dist

    _check(mesh, t)
    group = mesh.group(axis)
    if group is None:
        return t.clone()
    buf = _host(mesh, t).clone()
    dist.all_reduce(buf, group=group)
    return _back(mesh, buf)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in axis order
    (``lax.all_gather(..., tiled=True)``)."""
    import torch.distributed as dist

    _check(mesh, t)
    group = mesh.group(axis)
    if group is None:
        return t.clone()
    src = _host(mesh, t)
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in mesh.members(axis)]
    dist.all_gather(parts, src, group=group)
    return _back(mesh, torch.cat(parts, dim=dim))


def all_to_all(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Split dim 0 into one block per rank, send block j to rank j and
    concatenate the blocks received in rank order
    (``lax.all_to_all(..., split_axis=0, concat_axis=0, tiled=True)``)."""
    import torch.distributed as dist

    _check(mesh, t)
    group = mesh.group(axis)
    if group is None:
        return t.clone()
    if t.shape[0] % len(mesh.members(axis)):
        raise ValueError(f"dim 0 ({t.shape[0]}) does not split over {axis}")
    src = _host(mesh, t)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return _back(mesh, out)


def ring_shift(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``t`` of the rank before on ``axis``, cyclically: each rank sends to
    the next (``lax.ppermute`` with ``i -> i + 1``)."""
    import torch.distributed as dist

    _check(mesh, t)
    group = mesh.group(axis)
    if group is None:
        return t.clone()
    ranks = mesh.members(axis)
    i = ranks.index(mesh.rank)
    src = _host(mesh, t)
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(i + 1) % len(ranks)], group),
           dist.P2POp(dist.irecv, out, ranks[(i - 1) % len(ranks)], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return _back(mesh, out)


class _GatherDim(torch.autograd.Function):
    """Forward: the ranks' blocks concatenated along ``dim``; backward:
    this rank's block of the gradient.  Exact where every rank of the
    axis computes the same function of the gathered tensor, so that the
    gradient is equal on all of them (the training step's replicated
    computation after a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.width = mesh, axis, dim, x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        i = ctx.mesh.members(ctx.axis).index(ctx.mesh.rank)
        return grad.narrow(ctx.dim, i * ctx.width, ctx.width).contiguous(), None, None, None


class _SumGrad(torch.autograd.Function):
    """Forward: the identity; backward: the gradient summed over the axis
    (the input of a column-parallel product: each rank's slice of the
    output gives part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.mesh, ctx.axis), None, None


def gather_dim(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """Differentiable :func:`all_gather` along ``dim`` (see :class:`_GatherDim`)."""
    if mesh.group(axis) is None:
        return x
    return _GatherDim.apply(x, mesh, axis, dim % x.ndim)


def sum_grad(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The identity whose backward sums the gradient over ``axis``."""
    if mesh.group(axis) is None or not x.requires_grad:
        return x
    return _SumGrad.apply(x, mesh, axis)
