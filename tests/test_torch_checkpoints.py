"""The weight bridge on the trained zoo checkpoints.  Reading the orbax
checkpoint is the JAX side's business and happens only here; the port
takes the restored tree as numpy and loads every key with strict=True."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu.models import configs as jcfg
from marie_tpu.models.craft import CRAFT as JaxCRAFT
from marie_tpu.registry.checkpoints import load_params
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.registry.convert import _flatten, build_model, from_flax

ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "model_zoo")


@pytest.mark.parametrize("name,config", [
    ("craft-s2d2-synth", tcfg.CraftConfig.fast_s2d2()),
    ("trocr-fast3g2d6ov-synth", tcfg.TrOCRConfig.fast_v3_g2_d6()),
])
def test_zoo_checkpoint_loads_strict(name, config):
    tree = jax.device_get(load_params(os.path.join(ZOO, name)))
    model = from_flax(tree, build_model(config))  # strict: raises on any gap
    n_leaves = sum(1 for _ in _flatten(tree))
    n_bn = sum(1 for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d))
    assert len(model.state_dict()) == n_leaves + n_bn  # + num_batches_tracked
    if name.startswith("craft"):
        # trained weights through both frameworks: same heatmap
        page = np.random.default_rng(0).random((1, 64, 96, 3)).astype(np.float32)
        want = np.asarray(JaxCRAFT(jcfg.CraftConfig.fast_s2d2()).apply(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(page)))
        with torch.no_grad():
            got = model(torch.from_numpy(page)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("name,head,labels", [
    ("layout-classifier-chain", "sequence", 3),
    ("layout-indexer-chain", "token", 5),
])
def test_zoo_chain_heads_load_strict_and_match(name, head, labels):
    """The trained chain heads (synth width, sequence cap 192) load
    strictly into the port, and their logits on one encoded page match
    the JAX heads' within 1e-4 (float32 through 4 trained layers; the
    measured differences are 1e-6 to 4e-6)."""
    import dataclasses

    from marie_tpu.models.layoutlm import (
        LayoutLMv3ForSequenceClassification,
        LayoutLMv3ForTokenClassification,
    )
    from marie_tpu_torch.components.word_tokenizer import RollingWordTokenizer

    tree = jax.device_get(load_params(os.path.join(ZOO, name)))
    jconfig = dataclasses.replace(jcfg.LayoutLMConfig.synth(labels), max_seq_len=192)
    config = dataclasses.replace(tcfg.LayoutLMConfig.synth(labels), max_seq_len=192)
    model = from_flax(tree, build_model(config, head)).eval()  # strict
    assert len(model.state_dict()) == sum(1 for _ in _flatten(tree))
    rng = np.random.default_rng(0)
    words = ["invoice", "total", "amount", "due", "12/01/2023", "$45.00", "claim", "no"] * 5
    boxes = [[float(x) for x in rng.uniform(0, 700, 2)] + [60.0, 18.0] for _ in words]
    tokens, nboxes, n = RollingWordTokenizer(config.vocab_size).encode_page(
        words, boxes, (768, 1024), config.max_seq_len)
    seq_len = np.asarray([n], np.int32)
    jmodel = (LayoutLMv3ForSequenceClassification if head == "sequence"
              else LayoutLMv3ForTokenClassification)(jconfig)
    want = np.asarray(jmodel.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                                   tokens[None], nboxes[None], seq_len, None))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens[None]), torch.from_numpy(nboxes[None]),
                    torch.from_numpy(seq_len)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
