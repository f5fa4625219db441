"""Weight bridge: flax-layout numpy trees -> the port's ``nn.Module``s.

The JAX package stores flax variable trees (``{"params": ...,
"batch_stats": ...}``).  The port's modules carry the flax names, so a
flax path maps to a torch key by name; :func:`from_flax` converts each
leaf's layout and loads with ``strict=True`` (every key present, none
extra):

* Dense ``[in, out]`` -> Linear ``[out, in]``;
* DenseGeneral ``(H, dh)`` kernels ``[in, H, dh]`` -> ``[H*dh, in]``, and
  ``axis=(-2, -1)`` kernels ``[H, dh, out]`` -> ``[out, H*dh]`` (both
  are the row-major ``[in..., out...]`` kernel read as ``[in, out]``);
* Conv ``[kh, kw, I, O]`` -> ``[O, I, kh, kw]``;
* BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` ->
  weight, bias, running_mean, running_var;
* LayerNorm ``scale`` -> weight; Embed ``embedding`` -> weight;
* an ``OptimizedLSTMCell`` (input kernels ``ii``/``if``/``ig``/``io``
  ``[in, H]`` without bias, hidden kernels ``hi``/``hf``/``hg``/``ho``
  ``[H, H]`` with bias) -> one direction of a bidirectional ``nn.LSTM``
  (a model's ``flax_lstm_cells`` names which): the kernels concatenated
  in torch's gate order i, f, g, o and transposed into ``weight_ih`` and
  ``weight_hh``, the hidden biases into ``bias_hh``, and ``bias_ih``
  zero.

The bridge takes numpy: reading an orbax checkpoint is the JAX side's
business (the tests do it).  :func:`init_flax_layout` makes a full-width
tree from a seed, so a run on the card gets weights through this same
bridge without reading any checkpoint.
"""

from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from marie_tpu_torch.models.configs import CraftConfig, CRNNConfig, LayoutLMConfig, TrOCRConfig

Config = Union[CraftConfig, TrOCRConfig, LayoutLMConfig, CRNNConfig]
#: the LayoutLM heads by name
LAYOUT_HEADS = ("sequence", "token")

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
#: an OptimizedLSTMCell's gates, in torch's order
_LSTM_GATES = ("i", "f", "g", "o")


def build_model(config: Config, head: Optional[str] = None) -> nn.Module:
    """The port's module for a config (on the current default device).
    A :class:`LayoutLMConfig` takes ``head``: ``"sequence"`` (page
    classification) or ``"token"`` (NER); other configs take none."""
    from marie_tpu_torch.models.craft import CRAFT
    from marie_tpu_torch.models.crnn import CRNN
    from marie_tpu_torch.models.layoutlm import (
        LayoutLMv3ForSequenceClassification,
        LayoutLMv3ForTokenClassification,
    )
    from marie_tpu_torch.models.trocr import TrOCRModel

    if isinstance(config, LayoutLMConfig):
        if head not in LAYOUT_HEADS:
            raise ValueError(f"a LayoutLM head is one of {LAYOUT_HEADS}, got {head!r}")
        if head == "sequence":
            return LayoutLMv3ForSequenceClassification(config)
        return LayoutLMv3ForTokenClassification(config)
    if head is not None:
        raise ValueError(f"{type(config).__name__} takes no head, got {head!r}")
    if isinstance(config, CraftConfig):
        return CRAFT(config)
    if isinstance(config, TrOCRConfig):
        return TrOCRModel(config)
    if isinstance(config, CRNNConfig):
        return CRNN(config)
    raise TypeError(f"no port model for {type(config).__name__}")


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _split_collection(path: Tuple[str, ...]) -> Tuple[str, Tuple[str, ...]]:
    if path[0] in ("params", "batch_stats"):
        return path[0], path[1:]
    return "params", path


def _convert_leaf(mod: nn.Module, coll: str, leaf: str, arr: np.ndarray):
    if coll == "batch_stats":
        return _STAT_LEAF[leaf], arr
    name = _PARAM_LEAF.get(leaf, leaf)
    if leaf == "kernel" and isinstance(mod, nn.Linear):
        arr = arr.reshape(mod.in_features, mod.out_features).T
    elif leaf == "kernel" and isinstance(mod, nn.Conv2d):
        arr = arr.transpose(3, 2, 0, 1)
    elif leaf == "bias" and isinstance(mod, (nn.Linear, nn.Conv2d)):
        arr = arr.reshape(-1)
    return name, arr


def _lstm_state(cells: Dict[str, Dict[str, np.ndarray]],
                lstm_cells: Dict[str, Tuple[str, str]]) -> Dict[str, np.ndarray]:
    """The ``nn.LSTM`` parameters of flax LSTM cells ({cell: {"ii/kernel":
    ..., "hi/bias": ...}}); a cell without all of its leaves, or with
    others, raises as a strict load does."""
    want = {f"{k}{g}/kernel" for k in "ih" for g in _LSTM_GATES}
    want |= {f"h{g}/bias" for g in _LSTM_GATES}
    sd = {}
    for cell, (lstm, sfx) in lstm_cells.items():
        leaves = cells.pop(cell, {})
        if set(leaves) != want:
            raise RuntimeError(f"Missing key(s) or unexpected key(s) in LSTM cell {cell}: "
                               f"{sorted(want ^ set(leaves))}")
        bias = np.concatenate([leaves[f"h{g}/bias"] for g in _LSTM_GATES])
        for k in "ih":
            sd[f"{lstm}.weight_{k}h_l0{sfx}"] = np.concatenate(
                [leaves[f"{k}{g}/kernel"] for g in _LSTM_GATES], axis=1).T
        sd[f"{lstm}.bias_hh_l0{sfx}"] = bias
        sd[f"{lstm}.bias_ih_l0{sfx}"] = np.zeros_like(bias)
    if cells:
        raise RuntimeError(f"Unexpected LSTM cell(s) in the tree: {sorted(cells)}")
    return sd


def from_flax(tree: Dict[str, Any], module: nn.Module) -> nn.Module:
    """Load a flax-layout numpy tree into ``module`` (strict) and return it.

    ``tree`` is a variables dict (``{"params": ..., "batch_stats": ...}``)
    or a bare params tree; leaves are array-likes of any float dtype and
    are loaded as float32 (cast the module afterwards for bf16)."""
    sd: Dict[str, torch.Tensor] = {}
    lstm_cells = getattr(module, "flax_lstm_cells", {})
    cells: Dict[str, Dict[str, np.ndarray]] = {}
    for path, leaf_val in _flatten(tree):
        coll, names = _split_collection(path)
        if names[0] in lstm_cells or names[0].startswith("OptimizedLSTMCell_"):
            cells.setdefault(names[0], {})["/".join(names[1:])] = (
                np.asarray(leaf_val).astype(np.float32))
            continue
        *mod_path, leaf = names
        mod = module.get_submodule(".".join(mod_path))
        name, arr = _convert_leaf(mod, coll, leaf,
                                  np.asarray(leaf_val).astype(np.float32))
        key = ".".join(mod_path + [name])
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    for key, arr in _lstm_state(cells, lstm_cells).items():
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    for prefix, mod in module.named_modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            key = f"{prefix}.num_batches_tracked" if prefix else "num_batches_tracked"
            sd.setdefault(key, torch.zeros((), dtype=torch.long))
    module.load_state_dict(sd, strict=True)
    return module


def _flax_leaves(module: nn.Module):
    """(collection, flax path, flax shape, fan_in) of every flax leaf the
    module's parameters and BatchNorm statistics come from."""
    for cell, (lstm, _) in getattr(module, "flax_lstm_cells", {}).items():
        mod = module.get_submodule(lstm)
        for k, fan_in in (("i", mod.input_size), ("h", mod.hidden_size)):
            for g in _LSTM_GATES:
                yield "params", (cell, f"{k}{g}", "kernel"), (fan_in, mod.hidden_size), fan_in
        for g in _LSTM_GATES:
            yield "params", (cell, f"h{g}", "bias"), (mod.hidden_size,), 1
    for prefix, mod in module.named_modules():
        if isinstance(mod, nn.LSTM):
            continue  # its leaves are the flax cells' above
        mpath = tuple(prefix.split(".")) if prefix else ()
        for pname, p in mod.named_parameters(recurse=False):
            shape = tuple(p.shape)
            fan_in = 1
            if isinstance(mod, nn.Linear):
                flax = getattr(mod, "flax_shapes", {})
                if pname == "weight":
                    leaf = "kernel"
                    shape = flax.get("kernel", (mod.in_features, mod.out_features))
                    fan_in = mod.in_features
                else:
                    leaf, shape = "bias", flax.get("bias", shape)
            elif isinstance(mod, nn.Conv2d):
                if pname == "weight":
                    o, i, kh, kw = shape
                    leaf, shape, fan_in = "kernel", (kh, kw, i, o), kh * kw * i
                else:
                    leaf = "bias"
            elif isinstance(mod, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
                leaf = "scale" if pname == "weight" else "bias"
            elif isinstance(mod, nn.Embedding):
                leaf = "embedding"
            else:
                leaf = pname
            yield "params", mpath + (leaf,), shape, fan_in
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            for leaf in ("mean", "var"):
                yield "batch_stats", mpath + (leaf,), (mod.num_features,), 1


def init_flax_layout(config: Config, seed: int, head: Optional[str] = None) -> Dict[str, Any]:
    """A flax-layout variables tree of float32 numpy arrays for ``config``,
    drawn from ``np.random.default_rng(seed)``: kernels normal with std
    1/sqrt(fan_in), biases and position embeddings normal with std 0.02,
    norm scales 1 + N(0, 0.02), BatchNorm statistics mean N(0, 0.02) and
    var U(0.5, 1.5), embedding tables normal with std 1/sqrt(width).
    ``head`` as in :func:`build_model`."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        template = build_model(config, head)
    tree: Dict[str, Any] = {}
    for coll, path, shape, fan_in in _flax_leaves(template):
        leaf = path[-1]
        if leaf == "kernel":
            arr = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif leaf == "scale":
            arr = 1.0 + 0.02 * rng.standard_normal(shape)
        elif leaf == "var":
            arr = rng.uniform(0.5, 1.5, shape)
        elif leaf == "embedding":
            arr = rng.standard_normal(shape) / np.sqrt(shape[-1])
        else:  # bias, mean, pos_embed, cls_token, vis_pos
            arr = 0.02 * rng.standard_normal(shape)
        node = tree.setdefault(coll, {})
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[leaf] = arr.astype(np.float32)
    return tree


def load_model(config: Config, tree: Dict[str, Any], device="cuda",
               dtype: torch.dtype = torch.float32, head: Optional[str] = None) -> nn.Module:
    """Build the port's module for ``config`` (and ``head``, as in
    :func:`build_model`), load ``tree`` through :func:`from_flax`, move it
    to ``device`` in ``dtype``; eval mode, no gradients (the port serves
    inference only)."""
    from marie_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = from_flax(tree, build_model(config, head))
    return model.to(device=dev, dtype=dtype).eval().requires_grad_(False)
