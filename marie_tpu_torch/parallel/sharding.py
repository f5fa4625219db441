"""Sharding rules (port of ``marie_tpu/parallel/sharding.py``):
parameter and batch placement on a :class:`~marie_tpu_torch.parallel.mesh.Mesh`.

The parameter rule is JAX's: a leaf with ndim >= 2, at least ``min_size``
elements and a last dimension that divides by the model axis's size is
sharded on that last dimension over ``model``; every other leaf is
replicated.  It is evaluated on the flax-layout shapes (the shapes of
:func:`~marie_tpu_torch.registry.convert.to_flax`), and
:func:`param_shards` maps the chosen flax axis onto the torch tensor.
flax's last axis is often not the torch weight's last dimension: an
``nn.Dense`` kernel ``[in, out]`` is an ``nn.Linear`` weight ``[out,
in]``, and a ``DenseGeneral((H, dh))`` kernel ``[D, H, dh]`` shards
``dh``, which the port's ``nn.Linear`` flattens into ``H * dh`` rows.  So
a shard is a block along one dimension of a *view* of the torch tensor.

A spec is a tuple, as a ``PartitionSpec`` is: ``()`` replicated,
``(None, ..., "model")`` sharded on the last flax axis.
"""

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn

from marie_tpu_torch.parallel.mesh import Mesh
from marie_tpu_torch.registry.convert import _PARAM_LEAF, _flax_leaves


def _sharded(shape, m: int, min_size: int) -> bool:
    return (len(shape) >= 2 and math.prod(shape) >= min_size and m > 1
            and shape[-1] % m == 0)


def infer_param_sharding(params: Any, mesh: Mesh, model_axis: str = "model",
                         min_size: int = 2**14):
    """A tree shaped like ``params`` (a flax-layout tree of arrays) of
    specs: ``(None,) * (ndim - 1) + (model_axis,)`` for a sharded leaf,
    ``()`` for a replicated one."""
    m = mesh.shape[model_axis]

    def rule(leaf):
        if isinstance(leaf, dict):
            return {k: rule(v) for k, v in leaf.items()}
        shape = tuple(np.shape(leaf))
        if _sharded(shape, m, min_size):
            return (None,) * (len(shape) - 1) + (model_axis,)
        return ()

    return rule(params)


class Shard(NamedTuple):
    """A sharded torch parameter: its flax path, the view of the torch
    tensor whose dimension ``dim`` is the flax leaf's last axis (the
    stored shard is that view with ``dim`` cut to ``view[dim] / M``)."""

    flax_path: Tuple[str, ...]
    view: Tuple[int, ...]
    dim: int


def _torch_view(mod: nn.Module, pname: str, flax_shape, torch_shape) -> Tuple[Tuple[int, ...], int]:
    """(view, dim) of a torch parameter for its flax leaf's last axis
    (the layouts of ``registry/convert.py::_convert_leaf``)."""
    if isinstance(mod, nn.Linear) and pname == "weight":
        k = next(k for k in range(len(flax_shape) + 1)
                 if math.prod(flax_shape[:k]) == mod.in_features)
        out = tuple(flax_shape[k:])
        return out + (mod.in_features,), len(out) - 1
    if isinstance(mod, nn.Linear):  # bias: the flax bias shape, flattened
        return tuple(flax_shape), len(flax_shape) - 1
    if isinstance(mod, nn.Conv2d) and pname == "weight":  # [O, I, kh, kw]
        return tuple(torch_shape), 0
    if isinstance(mod, nn.ConvTranspose2d) and pname == "weight":  # [I, O, kh, kw]
        return tuple(torch_shape), 1
    if tuple(torch_shape) != tuple(flax_shape):
        raise ValueError(f"no shard layout for {type(mod).__name__}.{pname}: torch "
                         f"{tuple(torch_shape)} against flax {tuple(flax_shape)}")
    return tuple(torch_shape), len(torch_shape) - 1


def param_shards(module: nn.Module, mesh: Mesh, model_axis: str = "model",
                 min_size: int = 2**14) -> Dict[str, Shard]:
    """{torch parameter name: :class:`Shard`} of the parameters that
    :func:`infer_param_sharding` shards, judged on their flax shapes."""
    m = mesh.shape[model_axis]
    lstm_cells = getattr(module, "flax_lstm_cells", {})
    out: Dict[str, Shard] = {}
    for coll, path, shape, _ in _flax_leaves(module):
        if coll != "params" or not _sharded(tuple(shape), m, min_size):
            continue
        if path[0] in lstm_cells:
            raise ValueError(f"an LSTM cell's leaf cannot be sharded: {path}")
        mod = module.get_submodule(".".join(path[:-1]))
        pname = _PARAM_LEAF.get(path[-1], path[-1])
        view, dim = _torch_view(mod, pname, tuple(shape), tuple(getattr(mod, pname).shape))
        out[".".join(path[:-1] + (pname,))] = Shard(tuple(path), view, dim)
    return out


def shard_of(full: torch.Tensor, shard: Shard, index: int, count: int) -> torch.Tensor:
    """Block ``index`` of ``count`` of a full torch parameter, in the
    shard's view."""
    width = shard.view[shard.dim] // count
    return full.reshape(shard.view).narrow(shard.dim, index * width, width).contiguous()


def shard_batch(mesh: Mesh, data_axis: str = "data") -> Callable:
    """A rule for batch leaves, dim 0 sharded over ``data_axis`` (a 0-d
    leaf is whole everywhere).  On a world mesh ``rule(x)`` is this
    rank's block on its device; on a local mesh it is one block per entry
    (entry ``(d, ...)`` takes block ``d``), each on its entry's device."""

    def blocks(x: torch.Tensor, count: int):
        if x.ndim == 0:
            return [x] * count
        if x.shape[0] % count:
            raise ValueError(f"batch {x.shape[0]} does not divide over {count} {data_axis} "
                             "blocks")
        return list(torch.chunk(x, count, dim=0))

    d = mesh.shape.get(data_axis, 1)

    def rule(x):
        x = torch.as_tensor(x)
        parts = blocks(x, d)
        if mesh.is_world:
            return parts[mesh.axis_index(data_axis)].to(mesh.device)
        coord = np.indices(mesh.devices.shape).reshape(len(mesh.axis_names), -1)
        a = mesh.axis_names.index(data_axis) if data_axis in mesh.shape else None
        return [parts[0 if a is None else int(coord[a, i])].to(dev)
                for i, dev in enumerate(mesh.local_devices)]

    return rule


def replicated(mesh: Mesh) -> Callable:
    """A rule that places a whole leaf: on the rank's device (world), or
    on every entry's device (local, one tensor per entry)."""

    def rule(x):
        x = torch.as_tensor(x)
        if mesh.is_world:
            return x.to(mesh.device)
        return [x.to(dev) for dev in mesh.local_devices]

    return rule
