"""Sharded training step (port of ``marie_tpu/parallel/train.py``): data
parallel over ``data``, tensor parallel over ``model``, on a world
:class:`~marie_tpu_torch.parallel.mesh.Mesh`.

XLA partitions the JAX step from its shardings without changing the
function; here the partition is written out, and it computes the same
function as the unsharded step:

* Each rank keeps only its block of every leaf that
  :func:`~marie_tpu_torch.parallel.sharding.infer_param_sharding` shards
  (judged on the flax shapes, :func:`~marie_tpu_torch.parallel.sharding.param_shards`),
  and the AdamW state of that block.
* An ``nn.Linear`` with a sharded weight is column-parallel: the rank
  computes its block of the output features and the blocks are gathered
  along the feature axis (:func:`~marie_tpu_torch.parallel.collectives.gather_dim`,
  whose backward keeps this rank's block of the gradient); its input's
  gradient is summed over ``model``
  (:func:`~marie_tpu_torch.parallel.collectives.sum_grad`).  Any other
  sharded parameter (an embedding table, a convolution kernel, a
  position table) is gathered whole where the module reads it.
* The batch is sharded over ``data``.  The loss is the JAX loss of the
  whole batch: each rank's sum of token losses over the whole batch's
  token count (summed over ``data``), so the gradients summed over
  ``data`` are the whole batch's, whatever each block's share of padding.
* The optimizer is :class:`~marie_tpu_torch.train.optim.AdamW` with
  ``optax.adamw(1e-4)``'s settings, element-wise, so a block's state is
  the block of the whole state.

A mesh whose axes all have one entry (a local mesh of one device) runs
the same step without any collective: the one-rank step.
"""

import copy
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import parametrize

from marie_tpu_torch.parallel.collectives import all_gather, all_reduce, gather_dim, sum_grad
from marie_tpu_torch.parallel.mesh import Mesh
from marie_tpu_torch.parallel.sharding import Shard, param_shards, shard_batch, shard_of
from marie_tpu_torch.registry.convert import from_flax, to_flax
from marie_tpu_torch.train.optim import AdamW
from marie_tpu_torch.utils.device import float32_precision


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Masked token cross entropy. logits [B,L,V], targets [B,L]."""
    total, count = _loss_terms(logits, targets, pad_id)
    return total / torch.clamp(count, min=1.0)


def _loss_terms(logits, targets, pad_id):
    """(sum of the unmasked tokens' negative log-likelihoods, their count)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    mask = (targets != pad_id).to(torch.float32)
    return -(ll * mask).sum(), mask.sum()


def _adamw(params):
    """``optax.adamw(1e-4)``: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4."""
    return AdamW(params, lambda count: np.float32(1e-4))


def _column_parallel(mod: nn.Linear, mesh: Mesh, axis: str, weight: Shard,
                     bias: Optional[Shard]) -> None:
    """Make ``mod`` (its weight already this rank's block) compute its
    block of the output features and gather the blocks."""
    out_local = tuple(mod.weight.shape[:-1])

    def forward(x):
        lead = x.shape[:-1]
        w = mod.weight
        y = F.linear(sum_grad(x, mesh, axis), w.reshape(-1, w.shape[-1]))
        y = y.view(*lead, *out_local)
        if bias is not None:
            y = y + mod.bias
        y = gather_dim(y, mesh, axis, len(lead) + weight.dim).reshape(*lead, -1)
        if bias is None and mod.bias is not None:
            y = y + mod.bias
        return y

    mod.forward = forward


class _Gathered(nn.Module):
    """Parametrization: the stored block -> the whole parameter."""

    def __init__(self, mesh: Mesh, axis: str, shard: Shard, shape):
        super().__init__()
        self.mesh, self.axis, self.shard, self.shape = mesh, axis, shard, tuple(shape)

    def forward(self, block):
        return gather_dim(block, self.mesh, self.axis, self.shard.dim).reshape(self.shape)


def _shard_module(model: nn.Module, mesh: Mesh, model_axis: str) -> Dict[str, Shard]:
    """Keep this rank's block of every sharded parameter of ``model`` and
    rewire the modules that read them; returns the shards by name."""
    shards = param_shards(model, mesh, model_axis)
    if not shards:
        return shards
    m = mesh.axis_size(model_axis)
    idx = mesh.axis_index(model_axis)
    for name, shard in shards.items():
        mod_name, pname = name.rpartition(".")[::2]
        mod = model.get_submodule(mod_name)
        full = getattr(mod, pname)
        block = nn.Parameter(shard_of(full.detach(), shard, idx, m))
        if isinstance(mod, nn.Linear):
            setattr(mod, pname, block)
        else:
            shape = full.shape
            delattr(mod, pname)
            mod.register_parameter(pname, block)
            parametrize.register_parametrization(
                mod, pname, _Gathered(mesh, model_axis, shard, shape), unsafe=True)
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, nn.Linear) and f"{prefix}weight" in shards:
            _column_parallel(mod, mesh, model_axis, shards[f"{prefix}weight"],
                             shards.get(f"{prefix}bias"))
        elif isinstance(mod, nn.Linear) and f"{prefix}bias" in shards:
            raise ValueError(f"{mod_name}: a sharded bias needs a sharded weight")
    return shards


class TrainState:
    """One rank's part of the training state: the module (its sharded
    parameters as this rank's blocks), the names and shards of those
    parameters, and an unsharded template to rebuild the whole tree."""

    def __init__(self, model: nn.Module, shards: Dict[str, Shard], template: nn.Module):
        self.model, self.shards, self.template = model, shards, template

    def named_tensors(self):
        """(name, tensor) of every parameter as the unsharded module names
        it; sharded ones are this rank's block."""
        for name, p in self.model.named_parameters():
            yield name.replace("parametrizations.", "").replace(".original", ""), p


def make_train_step(model: nn.Module, mesh: Mesh, optimizer: Optional[Callable] = None,
                    pad_id: int = 2, data_axis: str = "data",
                    model_axis: str = "model") -> Tuple[Callable, Callable]:
    """Build (init_fn, step_fn) for TrOCR-style seq2seq training.

    ``init_fn(tree) -> (params, opt_state)``: the flax-layout numpy tree
    (the JAX package's initialisation, or any tree of the model) loaded
    into ``model`` through :func:`~marie_tpu_torch.registry.convert.from_flax`,
    on the rank's device, sharded; ``params`` is a :class:`TrainState`
    and ``opt_state`` its optimizer (``optimizer(parameters)``, default
    ``optax.adamw(1e-4)``'s AdamW).  ``step_fn(params, opt_state, images,
    tokens) -> (params, opt_state, loss)`` runs one step in place on this
    rank's batch block (``step_fn.place_batch(images, tokens)`` cuts it
    from the whole batch) and returns the whole batch's loss, float32 on
    the device.  ``step_fn.full_state(params)`` gathers every parameter
    whole, ``{torch name: tensor}`` on the rank's device, and
    ``step_fn.full_tree(params)`` the flax-layout tree (numpy); both are
    collectives (every rank calls them), and with ``grads=True`` give the
    last step's gradients (summed over ``data``) instead.
    Float32 matmuls and convolutions run without TF32."""
    optimizer = optimizer or _adamw
    device = mesh.device if mesh.is_world else mesh.local_devices[0]
    if not mesh.is_world and mesh.size != 1:
        raise ValueError("a training step over several devices needs a world mesh, one rank a device")
    for axis in (data_axis, model_axis):
        if axis not in mesh.shape:
            raise ValueError(f"the training mesh needs a {axis!r} axis, got {mesh.axis_names}")
    sharded = mesh.is_world and mesh.axis_size(model_axis) > 1
    multi_data = mesh.is_world and mesh.axis_size(data_axis) > 1

    def init_fn(tree):
        from_flax(tree, model)
        template = copy.deepcopy(model).to("meta")
        model.to(device).train().requires_grad_(True)
        shards = _shard_module(model, mesh, model_axis) if sharded else {}
        state = TrainState(model, shards, template)
        return state, optimizer([p for _, p in state.named_tensors()])

    def step_fn(params: TrainState, opt_state, images, tokens):
        with float32_precision(allow_tf32=False):
            opt_state.zero_grad()
            logits = params.model(images, tokens[:, :-1])
            total, count = _loss_terms(logits, tokens[:, 1:], pad_id)
            if multi_data:
                count = all_reduce(count.detach(), mesh, data_axis)
            loss = total / torch.clamp(count, min=1.0)
            loss.backward()
            if multi_data:
                _sum_grads_over(opt_state.params, mesh, data_axis)
            opt_state.step()
            if multi_data:
                loss = all_reduce(loss.detach(), mesh, data_axis)
        return params, opt_state, loss.detach()

    def place_batch(images, tokens):
        images = torch.as_tensor(np.asarray(images, np.float32))
        tokens = torch.as_tensor(np.asarray(tokens)).long()
        if not mesh.is_world:
            return images.to(device), tokens.to(device)
        rule = shard_batch(mesh, data_axis)
        return rule(images), rule(tokens)

    def full_state(params: TrainState, grads: bool = False) -> Dict[str, torch.Tensor]:
        whole = {}
        shapes = {name: p.shape for name, p in params.template.named_parameters()}
        for name, p in params.named_tensors():
            t = p.detach()
            if grads:
                t = torch.zeros_like(t) if p.grad is None else p.grad.detach()
            if name in params.shards:
                t = all_gather(t, mesh, model_axis, params.shards[name].dim)
            whole[name] = t.reshape(shapes[name])
        return whole

    def full_tree(params: TrainState, grads: bool = False):
        whole = {k: v.to("cpu") for k, v in full_state(params, grads).items()}
        template = copy.deepcopy(params.template).to_empty(device="cpu")
        for name, buf in params.model.named_buffers():
            whole[name] = buf.detach().to("cpu")
        template.load_state_dict(whole, strict=True)
        return to_flax(template)

    step_fn.place_batch = place_batch  # type: ignore[attr-defined]
    step_fn.full_state = full_state  # type: ignore[attr-defined]
    step_fn.full_tree = full_tree  # type: ignore[attr-defined]
    return init_fn, step_fn


def _sum_grads_over(params, mesh: Mesh, axis: str) -> None:
    """Sum every parameter's gradient over ``axis`` in one collective (a
    parameter the loss does not reach counts as zero)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh, axis)
    off = 0
    for p, g in zip(params, grads):
        p.grad = flat[off:off + g.numel()].view_as(g)
        off += g.numel()
