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
