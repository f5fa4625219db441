"""Every parallel leg over n devices, on tiny shapes (the port's
counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``):

    python -m marie_tpu_torch.parallel.dryrun 4                # on the card(s)
    python -m marie_tpu_torch.parallel.dryrun 4 --device cpu   # on the CPU

* **train**: one dp x tp step of a tiny TrOCR (tp = 2 where n is even)
  over a world of n ranks;
* **serve**: ``fused_ocr_pages`` with the page batch split over a local
  mesh of n entries, held equal to the call without a mesh;
* **pipeline**: a dp x pp GPipe schedule (pp = 2 where n is even), held
  to the sequential composition of the stages within 1e-5;
* **moe**: n experts over an ``expert`` axis, held to the per-token dense
  loop within 1e-5; **seq**: attention sharded n ways on the sequence,
  held to whole attention within 1e-5;
* **chain**: ``fused_ocr_chain`` (classifier and indexer heads) over the
  local mesh, held to the call without a mesh;
* **overlay**: the pix2pix generator with its batch split over the local
  mesh, held to the unsplit forward within 1e-5.

The world legs run in n spawned ranks (one world, every leg), the local
ones in this process.  On the CPU the world is gloo; on cards, NCCL where
the ranks fit on distinct cards, else gloo with its collectives staged
through host memory.  Tiny shapes: this checks the partitioning and the
collectives, not speed.  Every leg raises on a mismatch.
"""

import argparse
import copy
import sys
from typing import Dict

import numpy as np
import torch

TOL = 1e-5


def _stage(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def _tiny_trocr():
    from marie_tpu_torch.models.configs import DecoderConfig, TrOCRConfig, ViTConfig

    return TrOCRConfig(
        encoder=ViTConfig(image_size=(32, 64), patch_size=16, hidden_dim=64, num_layers=2,
                          num_heads=2, mlp_dim=128, use_cls_token=False),
        decoder=DecoderConfig(vocab_size=96, hidden_dim=64, num_layers=2, num_heads=2,
                              mlp_dim=128, max_len=8))


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def moe_reference(params, router, x) -> torch.Tensor:
    """The dense per-token top-1 MoE: each token through its chosen
    expert, scaled by its router probability (no capacity drops)."""
    ws, bs = params
    probs = torch.softmax(x @ router, dim=-1)
    choice = torch.argmax(probs, dim=-1)
    out = torch.stack([_stage((ws[e], bs[e]), x[t]) for t, e in enumerate(choice.tolist())])
    return out * probs.gather(1, choice[:, None])


def attention_reference(q, k, v) -> torch.Tensor:
    """Whole-sequence attention of ``[B, L, H, Dh]`` tensors."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q * scale, k), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def world_legs() -> Dict[str, object]:
    """The world legs on this rank (inside a world of n ranks)."""
    import torch.distributed as dist

    from marie_tpu_torch.ops.kernels._build import launch_path
    from marie_tpu_torch.parallel import create_mesh, make_train_step
    from marie_tpu_torch.parallel.distributed import world_device
    from marie_tpu_torch.parallel.moe import make_moe_fn
    from marie_tpu_torch.parallel.pipeline import make_pipelined_fn
    from marie_tpu_torch.parallel.sequence import make_seq_attention_fn
    from marie_tpu_torch.registry.convert import build_model, init_flax_defaults

    n, dev = dist.get_world_size(), world_device()
    out: Dict[str, object] = {}

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(dev)

    # train: dp x tp
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    cfg = _tiny_trocr()
    mesh = create_mesh((dp, tp))
    init_fn, step_fn = make_train_step(build_model(cfg), mesh)
    params, opt_state = init_fn(init_flax_defaults(cfg, 0))
    b = 2 * dp
    images, tokens = step_fn.place_batch(np.zeros((b, 32, 64, 3), np.float32),
                                         np.ones((b, cfg.decoder.max_len), np.int64))
    with launch_path("train"):
        params, opt_state, loss = step_fn(params, opt_state, images, tokens)
    out["train"] = {"mesh": [dp, tp], "loss": float(loss),
                    "sharded": sorted(params.shards)}
    if not np.isfinite(out["train"]["loss"]):
        raise AssertionError("dryrun train: the loss is not finite")

    # pipeline: dp x pp
    pp = 2 if n % 2 == 0 else 1
    dp2 = n // pp
    rng = np.random.default_rng(1)
    sp = (put(rng.normal(size=(pp, 16, 16)) * 0.3), put(rng.normal(size=(pp, 16)) * 0.1))
    micro = put(rng.normal(size=(2 * dp2, 4, 16)))
    got = make_pipelined_fn(create_mesh((dp2, pp), ("data", "pipe")), _stage)(sp, micro)
    ref = micro
    for s in range(pp):
        ref = _stage((sp[0][s], sp[1][s]), ref)
    out["pipeline"] = {"mesh": [dp2, pp], "max_abs_err": _max_err(got, ref)}

    # expert: one expert a rank
    rng = np.random.default_rng(2)
    eparams = (put(rng.normal(size=(n, 16, 16)) * 0.3), put(rng.normal(size=(n, 16)) * 0.1))
    router = put(rng.normal(size=(16, n)))
    toks = put(rng.normal(size=(16, 16)))
    got = make_moe_fn(create_mesh((n,), ("expert",)), _stage, capacity=16)(eparams, router, toks)
    out["moe"] = {"experts": n, "max_abs_err": _max_err(got, moe_reference(eparams, router, toks))}

    # sequence: the query sequence sharded n ways
    qkv = [put(rng.normal(size=(2, 4 * n, 2, 8))) for _ in range(3)]
    got = make_seq_attention_fn(create_mesh((n,), ("seq",)))(*qkv)
    out["seq"] = {"length": 4 * n, "max_abs_err": _max_err(got, attention_reference(*qkv))}
    for leg in ("pipeline", "moe", "seq"):
        if not out[leg]["max_abs_err"] <= TOL:
            raise AssertionError(f"dryrun {leg}: {out[leg]}")
    return out


def _local_devices(n: int, device: str):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)]
    return [dev] * n


def local_legs(n: int, device: str) -> Dict[str, object]:
    """The serve, chain and overlay legs over a local mesh of n entries."""
    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu_torch.components.word_tokenizer import RollingWordTokenizer
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.models.configs import (
        CraftConfig,
        LayoutLMConfig,
        Pix2PixConfig,
        TrOCRConfig,
    )
    from marie_tpu_torch.ocr.fused import fused_ocr_pages
    from marie_tpu_torch.ocr.fused_chain import fused_ocr_chain
    from marie_tpu_torch.parallel import create_mesh
    from marie_tpu_torch.preprocess.buckets import BucketSpec
    from marie_tpu_torch.registry.convert import init_flax_layout, load_model

    out: Dict[str, object] = {}
    devs = _local_devices(n, device)
    mesh = create_mesh((n,), ("pages",), devices=devs)
    home = devs[0]
    box = BoxProcessorCraft(CraftConfig.tiny(), init_flax_layout(CraftConfig.tiny(), 0),
                            box_source="heatmap", text_threshold=0.7, low_text=0.4,
                            max_components=16, bucket_spec=BucketSpec(shapes=((64, 64),)),
                            device=home)
    icr = TrOcrProcessor(TrOCRConfig.tiny(), init_flax_layout(TrOCRConfig.tiny(), 1),
                         batch_sizes=(16,), device=home)
    n_pages, compact_slots = 2 * n, 4
    pages = np.random.default_rng(0).integers(0, 255, (n_pages, 64, 64)).astype(np.uint8)
    whole = fused_ocr_pages(box, icr, pages, compact_slots=compact_slots)
    split = fused_ocr_pages(box, icr, pages, compact_slots=compact_slots, mesh=mesh)
    _same("serve", whole, split)
    if split[1].shape[0] != n_pages * compact_slots:
        raise AssertionError(f"dryrun serve: tokens {tuple(split[1].shape)}")
    out["serve"] = {"pages": n_pages, "entries": n, "tokens": list(split[1].shape)}

    heads = []
    for k, (cls, labels, head, num) in enumerate((
            (LayoutDocumentClassifier, ("a", "b", "c"), "sequence", 3),
            (LayoutDocumentIndexer, ("O", "B-K", "I-K", "B-V", "I-V"), "token", 5))):
        cfg = LayoutLMConfig(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=2,
                             mlp_dim=64, max_seq_len=16, use_image=False, num_labels=num)
        heads.append(cls(labels=labels, config=cfg, params=init_flax_layout(cfg, 2 + k, head),
                         tokenizer=RollingWordTokenizer(cfg.vocab_size), device=home))
    whole = fused_ocr_chain(box, icr, *heads, pages, compact_slots=compact_slots)
    split = fused_ocr_chain(box, icr, *heads, pages, compact_slots=compact_slots, mesh=mesh)
    _same("chain", whole[:3] + whole[4:5], split[:3] + split[4:5])
    err = _max_err(whole[3], split[3])
    if split[3].shape != (n_pages, 3) or split[4].shape != (n_pages, 16) or not err <= TOL:
        raise AssertionError(f"dryrun chain: logits {tuple(split[3].shape)}, labels "
                             f"{tuple(split[4].shape)}, error {err}")
    out["chain"] = {"pages": n_pages, "cls_logits_err": err}

    gcfg = Pix2PixConfig.tiny()
    gen = load_model(gcfg, init_flax_layout(gcfg, 3), device=home)
    batch = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2 * n, 32, 32, 3)).astype(np.float32)).to(home)
    gens = [gen if d == home else copy.deepcopy(gen).to(d) for d in devs]
    with torch.no_grad():
        blocks = mesh.run_each(lambda i, d: gens[i](batch[2 * i:2 * i + 2].to(d)).to(home))
        cleaned, ref = torch.cat(blocks), gen(batch)
    err = _max_err(cleaned, ref)
    if cleaned.shape != (2 * n, 32, 32, 3) or not err <= TOL:
        raise AssertionError(f"dryrun overlay: {tuple(cleaned.shape)}, error {err}")
    out["overlay"] = {"batch": 2 * n, "max_abs_err": err}
    return out


def _same(leg: str, want, got) -> None:
    """Tokens, stats and labels equal; float outputs within 1e-6."""
    stats_w, stats_g = want[0], got[0]
    for k in stats_w:
        if not torch.equal(stats_w[k], stats_g[k]):
            raise AssertionError(f"dryrun {leg}: stats {k} differ from the call without a mesh")
    for a, b in zip(want[1:], got[1:]):
        same = torch.equal(a, b) if not a.is_floating_point() else _max_err(a, b) <= 1e-6
        if not same:
            raise AssertionError(f"dryrun {leg}: outputs differ from the call without a mesh")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict[str, object]:
    """Run every leg over ``n_devices`` (see the module note); prints one
    line per leg and returns the legs' figures (the world legs' from
    rank 0).  Raises on a mismatch or a failed rank."""
    from marie_tpu_torch.parallel.distributed import spawn_world
    from marie_tpu_torch.utils.device import resolve_device

    resolve_device(device)
    world = spawn_world(world_legs, n_devices, device=device, timeout_s=300.0)[0]
    for leg in ("train", "pipeline", "moe", "seq"):
        print(f"dryrun_multichip {leg} ok: {world[leg]}", flush=True)
    local = local_legs(n_devices, device)
    for leg, row in local.items():
        print(f"dryrun_multichip {leg} ok: {row}", flush=True)
    return {**world, **local}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_devices", type=int, nargs="?", default=8)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
