"""Sequence parallelism (port of ``marie_tpu/parallel/sequence.py``):
attention with the query sequence sharded over a ``seq`` axis of a world
:class:`~marie_tpu_torch.parallel.mesh.Mesh` and K/V gathered over it.
Each rank attends its contiguous query block to the whole key/value
sequence; the outputs stay sequence-sharded, so a token-wise MLP after
it needs no re-layout.
"""


import torch

from marie_tpu_torch.parallel.collectives import all_gather
from marie_tpu_torch.parallel.mesh import Mesh

__all__ = ["seq_sharded_attention", "make_seq_attention_fn"]


def seq_sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                          axis: str = "seq") -> torch.Tensor:
    """This rank's blocks ``[B, L_local, H, Dh]`` of q, k and v -> its
    block of the attention output, ``[B, L_local, H, Dh]``: K/V gathered
    over ``axis``, softmax in float32."""
    k_full = all_gather(k, mesh, axis, dim=1)
    v_full = all_gather(v, mesh, axis, dim=1)
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=q.dtype, device=q.device))
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k_full)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_full)


def make_seq_attention_fn(mesh: Mesh, seq_axis: str = "seq"):
    """``fn(q, k, v)`` on each rank of a world mesh: q, k, v are the whole
    ``[B, L, H, Dh]`` tensors; the rank takes its block of dim 1, attends,
    and the blocks are gathered.  Returns the whole output on every rank."""

    def fn(q, k, v):
        n = mesh.axis_size(seq_axis)
        if q.shape[1] % n or k.shape[1] % n:
            raise ValueError(f"sequence lengths {q.shape[1]}, {k.shape[1]} do not split "
                             f"{n} ways")
        i = mesh.axis_index(seq_axis)
        blocks = [t[:, i * (t.shape[1] // n):][:, :t.shape[1] // n] for t in (q, k, v)]
        return all_gather(seq_sharded_attention(*blocks, mesh, axis=seq_axis), mesh,
                          seq_axis, dim=1)

    return fn
