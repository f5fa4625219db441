#!/usr/bin/env python
"""Where the port's CPU bf16 CRAFT leaves the JAX package's (XLA's CPU),
on the shipped pages of ``torch_zoo/``.  Needs JAX (run where the JAX
package runs)::

    python scripts/probe_craft_xla.py [--page 4] [--stock]

1. Block by block on one page: the jitted flax CRAFT's captured
   intermediates against the port's blocks fed the flax block's input:
   values that differ in the conv (sum and bias) and in the block output.
2. The heatmap of the whole model on that page: values that differ, and
   region-mask pixels that flip at 0.4 and 0.6.
3. The serving engine in the golden's configuration (``chip_smoke.py::
   zoo_engine("cpu")``) on the 16 pages in one group against
   ``golden.json``: boxes that moved per page, NER agreement, the pages
   whose boxes all equal the golden's and those of them whose NER labels
   differ (``check.py::agreement``).

``--stock`` runs steps 2-3 with torch's stock bf16 modules on the CPU
(the port before it rounded where XLA does).
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--page", type=int, default=4)
    ap.add_argument("--stock", action="store_true",
                    help="torch's stock bf16 modules on the CPU, not XLA's rounding")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    import torch.nn.functional as F

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from marie_tpu.models.configs import CraftConfig as JaxCraftConfig
    from marie_tpu.models.craft import CRAFT as JaxCRAFT
    from marie_tpu.utils.dtype import cast_floats
    from marie_tpu_torch.check import agreement
    from marie_tpu_torch.models import craft
    from marie_tpu_torch.models.configs import CraftConfig
    from marie_tpu_torch.preprocess.ops import normalize_page
    from marie_tpu_torch.registry.convert import load_model
    from marie_tpu_torch.registry.zoo import zoo_params

    bf16 = torch.bfloat16
    tree = zoo_params("craft-s2d2-synth")
    jvars = cast_floats(jax.tree_util.tree_map(jnp.asarray, tree), jnp.bfloat16)
    jmodel = JaxCRAFT(JaxCraftConfig.fast_s2d2())
    model = load_model(CraftConfig.fast_s2d2(), tree, "cpu", bf16)
    shipped = chip_smoke.load_shipped()
    page = torch.from_numpy(shipped["pages"][args.page])[None, ..., None].expand(1, -1, -1, 3)
    rgb = normalize_page(page)
    report = {"page": args.page, "stock": args.stock}

    # 1. block by block against the captured flax intermediates
    capture = jax.jit(lambda v, x: jmodel.apply(v, x.astype(jnp.bfloat16),
                                                capture_intermediates=True,
                                                mutable=["intermediates"]))
    _, state = capture(jvars, jnp.asarray(rgb.numpy()))
    # the heatmap as the engine's detect program computes it (jitted, cast
    # to float32 inside the program)
    heat_jax = jax.jit(lambda v, x: jmodel.apply(v, x.astype(jnp.bfloat16)).astype(
        jnp.float32))(jvars, jnp.asarray(rgb.numpy()))

    def captured(*path):
        node = state["intermediates"]
        for key in path:
            node = node[key]
        return torch.from_numpy(np.array(node["__call__"][0].astype(jnp.float32))).permute(
            0, 3, 1, 2)

    f = model.cfg.stem_stride
    b, h, w, c = rgb.shape
    x = rgb.to(bf16).reshape(b, h // f, f, w // f, f, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // f, w // f, f * f * c).permute(0, 3, 1, 2)
    blocks = []
    for stage, n in (("stage1", 2), ("stage2", 2), ("stage3", 3), ("stage4", 3),
                     ("stage5", 3)):
        for i in range(n):
            block = getattr(getattr(model, stage), f"ConvBNRelu_{i}")
            conv = block.Conv_0
            with torch.no_grad():
                y = F.conv2d(x.float(), conv.weight.float(), None, padding=conv.padding)
                y = (y.to(bf16).float() + conv.bias.float()[None, :, None, None]).to(bf16)
                out = block(x)
            want_conv = captured(stage, f"ConvBNRelu_{i}", "Conv_0")
            want = captured(stage, f"ConvBNRelu_{i}")
            blocks.append({"block": f"{stage}.{i}", "terms": conv.weight[0].numel(),
                           "values": want.numel(),
                           "conv_differ": int((y.float() != want_conv).sum()),
                           "out_differ": int((out.float() != want).sum())})
            x = want.to(bf16)
        x = F.max_pool2d(x, 2, 2)
    report["blocks"] = blocks

    # 2-3: the whole model and the engine, with or without XLA's rounding
    if args.stock:
        craft._xla_rounding = lambda x: False
    with torch.no_grad():
        t0 = time.perf_counter()
        heat = model(rgb.to(bf16)).float().numpy()
        report["forward_s"] = time.perf_counter() - t0
    heat_jax = np.asarray(heat_jax)
    report["heatmap"] = {"values": int(heat.size), "differ": int((heat != heat_jax).sum()),
                         "max_abs": float(np.abs(heat - heat_jax).max()),
                         "mask_flips": {str(t): int(((heat[..., 0] > t)
                                                     != (heat_jax[..., 0] > t)).sum())
                                        for t in (0.4, 0.6)}}
    engine = chip_smoke.zoo_engine("cpu")
    golden = shipped["golden"]["pages"]
    got = engine.extract(list(shipped["pages"]))
    moved = []
    for g, c in zip(golden, got):
        gb = {tuple(wd["box"]) for wd in g["words"]}
        cb = {tuple(wd["box"]) for wd in c["words"]}
        moved.append(len(gb ^ cb) // 2)
    agree = agreement(golden, got)
    report["engine"] = {"moved_boxes": sum(moved), "pages_with_moved_boxes": sum(
        m > 0 for m in moved), "moved_by_page": moved, "words": agree["words"],
        "ner": agree["ner"], "box_pages": agree["box_pages"], "ner_pages": agree["ner_pages"]}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
