"""The port's embeddings (``marie_tpu_torch/embeddings/``) against the JAX
package's on the CPU: ``LayoutEmbeddingsModel`` with the same encoder
tree (drawn by ``init_flax_layout``; the JAX default's
``PRNGKey(0)`` draw cannot be repeated in torch) within 1e-5 at tiny
width and on one LayoutLMv3-base batch (float32, summed in another
order; measured ~1e-7), the base batch also against
``torch_zoo/golden_classify.json``; ``HashingEmbeddings`` equal.
Mirrors ``tests/unit/test_components_extra.py::test_layout_embeddings``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from marie_tpu.embeddings import HashingEmbeddings as JaxHashing
from marie_tpu.embeddings import LayoutEmbeddingsModel as JaxLayoutEmbeddings
from marie_tpu.models import configs as jcfg
from marie_tpu_torch.embeddings import HashingEmbeddings, LayoutEmbeddingsModel
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.ops.kernels.flash_attention import flash_attention
from marie_tpu_torch.registry.convert import init_flax_layout
from marie_tpu_torch.registry.zoo import ZOO_DIR

ATOL = 1e-5
TEXTS = ["invoice total amount", "patient claim form due 12/01/2023", "",
         " ".join(["word"] * 90), "Main St Springfield IL 62704", "paid"]


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_layout_embeddings():
    """The JAX test's case on the port (tiny config, default weights)."""
    model = LayoutEmbeddingsModel(config=tcfg.LayoutLMConfig.tiny(), device="cpu")
    embs = model.get_embeddings(["invoice total amount", "patient claim form"])
    assert embs.shape == (2, 64) and embs.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(embs, axis=-1), 1.0, atol=1e-4)
    # deterministic + same text -> same embedding
    np.testing.assert_allclose(model.embed_query("invoice total amount"), embs[0], atol=1e-5)
    # different texts -> different embeddings
    assert np.abs(embs[0] - embs[1]).max() > 1e-3
    assert model.get_embeddings([]).shape == (0, 64)
    assert model.model.cfg.use_image is False


@pytest.mark.parametrize("n_texts", [1, 6])
def test_layout_embeddings_match_jax_tiny(n_texts):
    """Batches padded to 4 and 16, an empty text, a text past
    ``max_seq_len`` (64 at tiny width); no launch is counted on the CPU."""
    config = dataclasses.replace(tcfg.LayoutLMConfig.tiny(), use_image=False)
    tree = init_flax_layout(config, 3, "encoder")
    texts = TEXTS[:n_texts]
    before = flash_attention.launches
    got = LayoutEmbeddingsModel(tcfg.LayoutLMConfig.tiny(), tree, device="cpu").get_embeddings(
        texts)
    want = JaxLayoutEmbeddings(jcfg.LayoutLMConfig.tiny(), _jnp(tree)).get_embeddings(texts)
    assert got.shape == want.shape == (n_texts, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert flash_attention.launches == before


def test_layout_embeddings_base_width_match_jax_and_golden():
    """One LayoutLMv3-base batch (the 4 page texts of
    ``golden_classify.json``, its encoder seed): the port against JAX
    within 1e-5, and against the file's 6-decimal vectors."""
    with open(os.path.join(ZOO_DIR, "golden_classify.json")) as f:
        golden = json.load(f)
    with open(os.path.join(ZOO_DIR, "golden.json")) as f:
        pages = json.load(f)["pages"][:len(golden["embeddings"])]
    texts = [" ".join(w["text"] for w in p["words"]) for p in pages]
    config = dataclasses.replace(tcfg.LayoutLMConfig.base(), use_image=False)
    tree = init_flax_layout(config, golden["settings"]["seeds"]["embeddings"], "encoder")
    got = LayoutEmbeddingsModel(tcfg.LayoutLMConfig.base(), tree, device="cpu").get_embeddings(
        texts)
    want = JaxLayoutEmbeddings(jcfg.LayoutLMConfig.base(), _jnp(tree)).get_embeddings(texts)
    assert got.shape == (4, 768)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(golden["embeddings"], np.float32), rtol=0,
                               atol=ATOL)


def test_hashing_embeddings_match_jax():
    got = HashingEmbeddings(dim=64).get_embeddings(TEXTS)
    want = JaxHashing(dim=64).get_embeddings(TEXTS)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(HashingEmbeddings(dim=64).embed_query("paid"), want[-1])
