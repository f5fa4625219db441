"""Port models against the flax models on the CPU, with the same
flax-layout weights (drawn by ``init_flax_layout``) fed to both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu.models import configs as jcfg
from marie_tpu.models.craft import CRAFT as JaxCRAFT
from marie_tpu.models.layers import sinusoidal_positions as jax_sinusoidal
from marie_tpu.models.trocr import TrOCRModel as JaxTrOCR
from marie_tpu.models.trocr import greedy_decode as jax_greedy
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.models.craft import resize_bilinear
from marie_tpu_torch.models.layers import sinusoidal_positions
from marie_tpu_torch.models.trocr import greedy_decode
from marie_tpu_torch.registry.convert import (
    _flatten,
    from_flax,
    build_model,
    init_flax_layout,
    load_model,
)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("preset", ["tiny", "fast_s2d2"])
def test_craft_heatmap_matches_flax(preset):
    cfg_t = getattr(tcfg.CraftConfig, preset)()
    cfg_j = getattr(jcfg.CraftConfig, preset)()
    tree = init_flax_layout(cfg_t, seed=3)
    rng = np.random.default_rng(4)
    pages = rng.random((2, 64, 96, 3)).astype(np.float32)
    want = np.asarray(JaxCRAFT(cfg_j).apply(_jax_tree(tree), jnp.asarray(pages)))
    model = load_model(cfg_t, tree, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(pages)).numpy()
    assert got.shape == want.shape == (2, 32, 48, 2)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("src_hw,dst_hw", [((2, 3), (4, 6)), ((4, 6), (8, 12)),
                                           ((3, 5), (7, 11))])
def test_resize_is_jax_bilinear_for_upsampling(src_hw, dst_hw):
    """CRAFT's U-Net only upsamples, where ``jax.image.resize`` bilinear
    (which antialiases only when it downsamples) equals
    ``F.interpolate(bilinear, align_corners=False, antialias=False)``."""
    x = np.random.default_rng(0).random((1, *src_hw, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, *dst_hw, 3), method="bilinear")
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), dst_hw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-6)


@pytest.mark.parametrize("preset", ["tiny", "fast_v3_g2_d6"])
def test_trocr_encoder_and_greedy_tokens_match_flax(preset):
    cfg_t = getattr(tcfg.TrOCRConfig, preset)()
    cfg_j = getattr(jcfg.TrOCRConfig, preset)()
    tree = init_flax_layout(cfg_t, seed=5)
    h, w = cfg_t.encoder.image_size
    rng = np.random.default_rng(6)
    crops = rng.random((4, h, w, 3)).astype(np.float32)
    jmodel = JaxTrOCR(cfg_j)
    params = _jax_tree(tree)
    model = load_model(cfg_t, tree, device="cpu")

    want_enc = np.asarray(jmodel.apply(params, jnp.asarray(crops),
                                       method=JaxTrOCR.encode))
    with torch.no_grad():
        got_enc = model.encode(torch.from_numpy(crops)).numpy()
    np.testing.assert_allclose(got_enc, want_enc, atol=1e-4)

    active = np.asarray([True, True, False, True])
    caps = np.asarray([6, 9, 9, 7], np.int32)
    steps = min(10, cfg_t.decoder.max_len)
    jt, jl, jc = jax_greedy(jmodel, params, jnp.asarray(crops), steps,
                            active=jnp.asarray(active), step_caps=jnp.asarray(caps))
    tt, tl, tc = greedy_decode(model, torch.from_numpy(crops), steps,
                               active=torch.from_numpy(active),
                               step_caps=torch.from_numpy(caps))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    assert (tt.numpy()[2] == cfg_t.decoder.pad_id).all()  # inactive row


def test_greedy_decode_exits_early_when_all_rows_finish():
    """Every row inactive: the loop never steps; tokens are all pad and
    the confidence is exp(0)."""
    cfg = tcfg.TrOCRConfig.tiny()
    model = load_model(cfg, init_flax_layout(cfg, 0), device="cpu")
    crops = torch.rand(3, 32, 64, 3)
    calls = []
    step = model.decode_step
    model.decode_step = lambda *a: calls.append(1) or step(*a)
    toks, lens, conf = greedy_decode(model, crops, 8,
                                     active=torch.zeros(3, dtype=torch.bool))
    assert not calls
    assert (toks == cfg.decoder.pad_id).all() and (lens == 0).all()
    assert torch.equal(conf, torch.ones(3))


@pytest.mark.parametrize("config", [tcfg.CraftConfig.fast_s2d2(),
                                    tcfg.TrOCRConfig.fast_v3_g2_d6()])
def test_init_flax_layout_has_the_flax_tree(config):
    """Same paths and shapes as ``model.init`` of the flax module."""
    if isinstance(config, tcfg.CraftConfig):
        jm, args = JaxCRAFT(jcfg.CraftConfig.fast_s2d2()), (jnp.zeros((1, 64, 96, 3)),)
    else:
        jm = JaxTrOCR(jcfg.TrOCRConfig.fast_v3_g2_d6())
        args = (jnp.zeros((1, 48, 320, 3)), jnp.zeros((1, 2), jnp.int32))
    want = {p: tuple(x.shape) for p, x in _flatten(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args))}
    got = {p: np.shape(x) for p, x in _flatten(init_flax_layout(config, 0))}
    assert got == want


def test_from_flax_is_strict():
    cfg = tcfg.TrOCRConfig.tiny()
    tree = init_flax_layout(cfg, 0)
    del tree["params"]["decoder"]["ln_f"]["bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        from_flax(tree, build_model(cfg))


def test_from_flax_layouts():
    """DenseGeneral q/out kernels and conv kernels land transposed as the
    torch layout expects: a torch forward equals the flax formula."""
    cfg = tcfg.TrOCRConfig.tiny()
    tree = init_flax_layout(cfg, 1)
    model = from_flax(tree, build_model(cfg))
    attn = tree["params"]["encoder"]["layer_0"]["attn"]
    x = np.random.default_rng(2).standard_normal((1, 3, 64)).astype(np.float32)
    q_flax = np.einsum("bld,dhk->blhk", x, attn["q"]["kernel"]) + attn["q"]["bias"]
    q_port = model.encoder.layer_0.attn.q(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(q_port, q_flax.reshape(1, 3, -1), atol=1e-5)
    y = np.random.default_rng(3).standard_normal((1, 3, 2, 32)).astype(np.float32)
    o_flax = np.einsum("blhk,hkd->bld", y, attn["out"]["kernel"]) + attn["out"]["bias"]
    o_port = model.encoder.layer_0.attn.out(torch.from_numpy(y.reshape(1, 3, 64))).detach().numpy()
    np.testing.assert_allclose(o_port, o_flax, atol=1e-5)


def test_sinusoidal_positions_match_flax():
    np.testing.assert_allclose(sinusoidal_positions(20, 64).numpy(),
                               np.asarray(jax_sinusoidal(20, 64)), atol=1e-6)
