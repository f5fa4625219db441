"""Checkpoint save/load for flax-layout numpy trees, and torch state-dict
conversion (counterpart of ``marie_tpu/registry/checkpoints.py``).

The JAX package keeps its trees as orbax checkpoints, which need JAX to
read; the port keeps them as one ``.npz`` file each, with the tree's
paths joined by ``/`` as keys, so numpy alone reads them.  A tree saved
with ``dtype="bfloat16"`` holds its float leaves as bfloat16 bits
(``uint16`` under the key plus :data:`BF16_SUFFIX`, rounded to nearest
even as ``astype(bfloat16)`` rounds); :func:`load_params` widens them to
float32, which is exact, so a processor that casts its weights to
bfloat16 gets the same bits as from the float32 tree.

:func:`registry.convert.from_flax` / :func:`registry.convert.load_model`
stay the only way from a tree into a module.
"""

import os
from typing import Any, Callable, Dict, Optional

import numpy as np

#: key suffix of a leaf stored as bfloat16 bits
BF16_SUFFIX = "@bfloat16"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(f"tree key {k!r} holds '/'")
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (uint16), rounded to nearest even."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    if not np.isfinite(x).all():
        raise ValueError("bfloat16 storage takes finite values only")
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits (uint16) -> float32 (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def save_params(params: Any, path: str, dtype: Optional[str] = None) -> None:
    """Write a flax-layout tree (nested dicts of arrays) to ``path`` as a
    compressed ``.npz``.  ``dtype="bfloat16"`` stores every float leaf as
    bfloat16 bits; by default leaves keep their dtype."""
    if dtype not in (None, "bfloat16"):
        raise ValueError(f"dtype must be None or 'bfloat16', got {dtype!r}")
    flat = {}
    for key, arr in _flatten(params).items():
        if dtype == "bfloat16" and np.issubdtype(arr.dtype, np.floating):
            flat[key + BF16_SUFFIX] = _to_bf16_bits(arr)
        else:
            flat[key] = arr
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez_compressed(f, **flat)


def load_params(path: str) -> Dict[str, Any]:
    """Read a tree written by :func:`save_params`: nested dicts of numpy
    arrays, bfloat16 leaves widened to float32."""
    tree: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            arr = data[key]
            if key.endswith(BF16_SUFFIX):
                key, arr = key[: -len(BF16_SUFFIX)], _from_bf16_bits(arr)
            *parents, leaf = key.split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = arr
    return tree


def torch_state_dict(pt_path: str) -> Dict[str, np.ndarray]:
    """Read a torch checkpoint into numpy arrays (on the CPU)."""
    import torch

    sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}


def convert_linear(w: np.ndarray) -> np.ndarray:
    """torch Linear weight [out, in] -> flax Dense kernel [in, out]."""
    return np.ascontiguousarray(w.T)


def convert_conv2d(w: np.ndarray) -> np.ndarray:
    """torch Conv2d weight [O, I, Kh, Kw] -> flax Conv kernel [Kh, Kw, I, O]."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def map_state_dict(
    sd: Dict[str, np.ndarray],
    rules: Dict[str, Callable[[Dict[str, np.ndarray]], np.ndarray]],
) -> Dict[str, np.ndarray]:
    """Apply {flax_path: fn(sd) -> array} mapping rules."""
    return {path: fn(sd) for path, fn in rules.items()}
