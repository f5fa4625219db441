"""Expert parallelism (port of ``marie_tpu/parallel/moe.py``): top-1
routed mixture of experts with the tokens exchanged over an ``expert``
axis of a world :class:`~marie_tpu_torch.parallel.mesh.Mesh` by
all-to-all (``torch.distributed.all_to_all_single``): each rank holds ONE
expert's parameters, the router's choices move tokens to their expert's
rank and back.  Tokens shard over ``data`` where the mesh has it.
"""

from typing import Any, Callable

import torch
import torch.nn.functional as F

from marie_tpu_torch.parallel.collectives import all_gather, all_to_all
from marie_tpu_torch.parallel.mesh import Mesh

__all__ = ["moe_apply", "make_moe_fn"]


def moe_apply(expert_params: Any, x: torch.Tensor, router_w: torch.Tensor,
              expert_fn: Callable, capacity: int, mesh: Mesh,
              axis: str = "expert") -> torch.Tensor:
    """Top-1 MoE on this rank: ``x`` ``[T, D]`` are its tokens,
    ``expert_params`` its expert's, ``router_w`` ``[D, E]`` the shared
    router.  Tokens past ``capacity`` per (rank, expert) pair are dropped
    (their output is zero); every other token's output is scaled by its
    router probability.  Returns ``[T, D]``."""
    e_count = mesh.axis_size(axis)
    t, d = x.shape
    probs = torch.softmax(x @ router_w, dim=-1)  # [T, E]
    choice = torch.argmax(probs, dim=-1)  # [T]
    gate = torch.gather(probs, 1, choice[:, None])[:, 0]

    # each token's place in its expert's capacity buffer
    onehot = F.one_hot(choice, e_count).to(torch.int32)  # [T, E]
    pos = torch.cumsum(onehot, dim=0) * onehot - 1  # -1 where not routed
    slot = (pos * onehot).sum(dim=1)
    keep = (slot >= 0) & (slot < capacity)

    # dispatch[t, e, c] = 1 where token t sits at slot c of expert e
    disp = (F.one_hot(choice, e_count).to(x.dtype)[:, :, None]
            * F.one_hot(torch.clamp(slot, 0, capacity - 1).long(), capacity).to(x.dtype)[:, None, :]
            * keep[:, None, None].to(x.dtype))  # [T, E, C]
    send = torch.einsum("tec,td->ecd", disp, x)  # [E, C, D]
    # after the exchange this rank holds its expert's tokens from every peer
    recv = all_to_all(send, mesh, axis)
    hidden = expert_fn(expert_params, recv.reshape(e_count * capacity, d))
    back = all_to_all(hidden.reshape(e_count, capacity, d), mesh, axis)
    out = torch.einsum("tec,ecd->td", disp, back)
    return out * gate[:, None]


def make_moe_fn(mesh: Mesh, expert_fn: Callable, capacity: int, expert_axis: str = "expert",
                data_axis: str = "data") -> Callable:
    """``fn(stacked_expert_params, router_w, x) -> y`` on each rank of a
    world mesh: rank ``e`` of ``expert_axis`` takes slice ``e`` of every
    stacked parameter (a tuple or list of tensors), ``x`` is all the
    tokens ``[T, D]``, sharded over ``data_axis`` where it has more than
    one rank.  Returns all the tokens' outputs on every rank."""
    has_data = mesh.axis_size(data_axis) > 1

    def fn(stacked_params, router_w, x):
        local = type(stacked_params)(p[mesh.axis_index(expert_axis)] for p in stacked_params)
        if has_data:
            block = x.shape[0] // mesh.axis_size(data_axis)
            x = x[mesh.axis_index(data_axis) * block:][:block]
        y = moe_apply(local, x, router_w, expert_fn, capacity, mesh, axis=expert_axis)
        return all_gather(y, mesh, data_axis) if has_data else y

    return fn
