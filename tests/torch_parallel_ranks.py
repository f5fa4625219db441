"""Rank functions of the port's parallel tests (``test_torch_parallel*.py``).

A spawned rank imports the module of the function it runs; this one
imports torch and the port only, so no rank loads JAX.
"""

import numpy as np
import torch

TRAIN_STEPS = 2


def _tensors(dev, *arrays):
    return tuple(torch.as_tensor(np.asarray(a, np.float32)).to(dev) for a in arrays)


def _stage(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def train_case(mesh_shape, cfg, tree, images, tokens):
    """``TRAIN_STEPS`` steps of the port's sharded step on ``mesh_shape``
    (a world or, for (1, 1), one local CPU entry): (losses, the whole
    flax tree after them, the sharded parameters' names, each step's
    gradient tree)."""
    from marie_tpu_torch.parallel import create_mesh, make_train_step
    from marie_tpu_torch.registry.convert import build_model

    if mesh_shape == (1, 1):
        mesh = create_mesh((1, 1), devices=["cpu"])
    else:
        mesh = create_mesh(mesh_shape)
    init_fn, step_fn = make_train_step(build_model(cfg), mesh)
    params, opt_state = init_fn(tree)
    images, tokens = step_fn.place_batch(images, tokens)
    losses, grads = [], []
    for _ in range(TRAIN_STEPS):
        params, opt_state, loss = step_fn(params, opt_state, images, tokens)
        losses.append(float(loss))
        grads.append(step_fn.full_tree(params, grads=True))
    return losses, step_fn.full_tree(params), sorted(params.shards), grads


def world_cases(payload):
    """Every world case of ``test_torch_parallel_world.py`` on this rank of
    a world of 4 (their outputs as numpy; equal on every rank)."""
    import torch.distributed as dist

    from marie_tpu_torch.parallel import create_mesh
    from marie_tpu_torch.parallel.distributed import host_shard_bounds, world_device
    from marie_tpu_torch.parallel.moe import make_moe_fn
    from marie_tpu_torch.parallel.pipeline import make_pipelined_fn
    from marie_tpu_torch.parallel.sequence import make_seq_attention_fn

    dev = world_device()
    out = {"rank": dist.get_rank(), "bounds": host_shard_bounds(10)}
    cfg, tree, images, tokens = payload["train"]
    for shape in ((2, 2), (4, 1)):
        out[("train", shape)] = train_case(shape, cfg, tree, images, tokens)
    for shape, axes in (((4,), ("pipe",)), ((2, 2), ("data", "pipe"))):
        params, batch = payload[("pipeline", shape)]
        fn = make_pipelined_fn(create_mesh(shape, axes), _stage)
        out[("pipeline", shape)] = fn(_tensors(dev, *params), *_tensors(dev, batch)).numpy()
    for shape, axes in (((4,), ("expert",)), ((2, 2), ("data", "expert"))):
        mesh = create_mesh(shape, axes)
        for capacity, (params, router, x) in payload[("moe", shape)].items():
            fn = make_moe_fn(mesh, _stage, capacity=capacity)
            out[("moe", shape, capacity)] = fn(_tensors(dev, *params),
                                               *_tensors(dev, router, x)).numpy()
    q, k, v = _tensors(dev, *payload["seq"])
    out["seq"] = make_seq_attention_fn(create_mesh((4,), ("seq",)))(q, k, v).numpy()
    return out


def jax_env_case():
    """Join a world from the JAX package's environment names, then:
    (joined, this process's bounds of 10 items, the world's sum of each
    process's [2, 4] block of its rank + 1)."""
    from marie_tpu_torch.parallel import create_mesh
    from marie_tpu_torch.parallel.collectives import all_reduce
    from marie_tpu_torch.parallel.distributed import (
        host_shard_bounds,
        initialize_distributed,
        world_device,
    )

    joined = initialize_distributed(device="cpu")
    mesh = create_mesh((2,), ("data",))
    local = torch.full((2, 4), float(mesh.rank + 1), device=world_device())
    total = all_reduce(local.sum(), mesh, "data")
    return joined, host_shard_bounds(10), float(total)
