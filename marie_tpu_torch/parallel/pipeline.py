"""Pipeline parallelism (port of ``marie_tpu/parallel/pipeline.py``):
GPipe-style microbatched stages over a ``pipe`` axis of a world
:class:`~marie_tpu_torch.parallel.mesh.Mesh`, activations handed to the
next stage by a ring send / receive
(:func:`~marie_tpu_torch.parallel.collectives.ring_shift`, the port's
``lax.ppermute``).

Rank ``s`` of the axis holds stage ``s``'s parameters.  Microbatches flow
through the stages in ``S + M - 1`` ticks (S stages, M microbatches):
each tick every stage computes, then hands its activations on.  The last
stage's outputs are made whole on every stage by a sum over ``pipe`` of
its masked outputs.  On a ``(data, pipe)`` mesh the microbatches shard
over ``data`` and every data block pipelines over its own ``pipe`` line.
"""

from typing import Any, Callable

import torch

from marie_tpu_torch.parallel.collectives import all_gather, all_reduce, ring_shift
from marie_tpu_torch.parallel.mesh import Mesh

__all__ = ["pipeline_apply", "make_pipelined_fn"]


def pipeline_apply(stage_params: Any, microbatches: torch.Tensor, stage_fn: Callable,
                   mesh: Mesh, axis: str = "pipe") -> torch.Tensor:
    """Run ``stage_fn`` as a pipeline over ``axis`` on this rank:
    ``stage_params`` are this stage's, ``microbatches`` ``[M, ...]`` are
    read on stage 0 (other stages' copies are ignored).  Returns the ``[M,
    ...]`` outputs on every stage."""
    s_count = mesh.axis_size(axis)
    stage = mesh.axis_index(axis)
    m_count = microbatches.shape[0]
    cur = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(s_count + m_count - 1):
        # stage 0 injects microbatch t while t < M; later stages take the
        # previous stage's activations of the tick before
        x_in = microbatches[min(max(t, 0), m_count - 1)] if stage == 0 else cur
        y = stage_fn(stage_params, x_in)
        slot = t - (s_count - 1)  # the last stage ends microbatch t - S + 1 at tick t
        if stage == s_count - 1 and 0 <= slot < m_count:
            outs[slot] = y
        cur = ring_shift(y, mesh, axis)
    return all_reduce(outs if stage == s_count - 1 else torch.zeros_like(outs), mesh, axis)


def make_pipelined_fn(mesh: Mesh, stage_fn: Callable, pipe_axis: str = "pipe",
                      data_axis: str = "data") -> Callable:
    """``fn(stacked_stage_params, batch) -> out`` on each rank of a world
    mesh: ``stacked_stage_params`` is a tuple (or list) of tensors whose
    leading dimension is the stage (size ``mesh.shape[pipe_axis]``; rank
    ``s`` of the axis takes slice ``s``), ``batch`` is the whole ``[M, mb,
    ...]`` microbatch stack.  With a ``data_axis`` of more than one rank
    the microbatches shard over it.  Returns the whole output on every
    rank."""
    has_data = mesh.axis_size(data_axis) > 1

    def fn(stacked_params, batch):
        stage = mesh.axis_index(pipe_axis)
        local = type(stacked_params)(p[stage] for p in stacked_params)
        if has_data:
            block = batch.shape[0] // mesh.axis_size(data_axis)
            batch = batch[mesh.axis_index(data_axis) * block:][:block]
        out = pipeline_apply(local, batch, stage_fn, mesh, axis=pipe_axis)
        return all_gather(out, mesh, data_axis) if has_data else out

    return fn
