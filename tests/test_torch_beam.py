"""The port's TrOCR beam search against the JAX package's on the CPU:
``beam_decode`` on ``TrOCRConfig.tiny`` in float32 at beam 1 and 5
(tokens and lengths equal, confidences within 1e-5), beam 1 against the
port's greedy decode, ties in the top-k (broken by index as
``jax.lax.top_k`` breaks them), and the TrOCR processor with
``beam_size=5`` on device pages and host fragments.

The seeded trees scale the EOS column of the output head, so that the
hypotheses end at different steps."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor as JaxTrOcrProcessor
from marie_tpu.models import configs as jcfg
from marie_tpu.models.trocr import TrOCRModel as JaxTrOCR
from marie_tpu.models.trocr import beam_decode as jax_beam_decode
from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.models.trocr import _top_k, beam_decode, greedy_decode
from marie_tpu_torch.registry.convert import init_flax_layout, load_model

CFG_T, CFG_J = tcfg.TrOCRConfig.tiny(), jcfg.TrOCRConfig.tiny()
EOS = CFG_T.decoder.eos_id


def _tree(seed: int, eos_boost: float):
    tree = init_flax_layout(CFG_T, seed)
    tree["params"]["decoder"]["lm_head"]["kernel"][:, EOS] *= eos_boost
    return tree


def _crops(seed: int, n: int = 6) -> np.ndarray:
    h, w = CFG_T.encoder.image_size
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(np.float32)


def _both(tree, crops, beam_size):
    want = jax_beam_decode(JaxTrOCR(CFG_J), jax.tree_util.tree_map(jnp.asarray, tree),
                           jnp.asarray(crops), beam_size=beam_size)
    got = beam_decode(load_model(CFG_T, tree, device="cpu"), torch.from_numpy(crops), beam_size)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("seed,eos_boost", [(9, 2.0), (5, 3.0), (9, 3.0), (7, 2.0)])
@pytest.mark.parametrize("beam_size", [1, 5])
def test_beam_decode_matches_jax(seed, eos_boost, beam_size):
    (jt, jl, jc), (tt, tl, tc) = _both(_tree(seed, eos_boost), _crops(seed), beam_size)
    assert tt.shape == jt.shape == (6, CFG_T.decoder.max_len)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-5)
    assert tt.dtype == tl.dtype == np.int32 and tc.dtype == np.float32


def test_beam_decode_lengths_differ_across_rows():
    """The cases above include hypotheses that end early and late."""
    lengths = set()
    for seed, boost in ((9, 2.0), (5, 3.0), (9, 3.0)):
        lengths |= set(_both(_tree(seed, boost), _crops(seed), 5)[1][1].tolist())
    assert len(lengths) >= 3 and min(lengths) < CFG_T.decoder.max_len


@pytest.mark.parametrize("seed", [3, 9])
def test_beam_size_one_matches_greedy(seed):
    """Beam 1 emits greedy's tokens.  Their lengths agree where greedy
    emitted no PAD token before EOS: greedy counts non-PAD tokens, the
    beam counts steps before EOS (as in the JAX package)."""
    model = load_model(CFG_T, _tree(seed, 2.0), device="cpu")
    crops = torch.from_numpy(_crops(seed))
    gt, gl, _ = greedy_decode(model, crops)
    bt, bl, _ = beam_decode(model, crops, 1)
    assert torch.equal(gt, bt)
    no_pad = []
    for r in range(len(gt)):
        row = gt[r].tolist()
        end = row.index(CFG_T.decoder.pad_id) if CFG_T.decoder.pad_id in row else len(row)
        no_pad.append(int(gl[r]) == end)
    assert any(no_pad)
    assert torch.equal(gl[no_pad], bl[no_pad])


def test_top_k_orders_ties_as_jax():
    x = np.random.default_rng(0).integers(-3, 3, (7, 40)).astype(np.float32)
    x[2] = 0.0
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 5)
    got_v, got_i = _top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_beam_decode_ties_pick_jax_beams():
    """A zero output head makes every token equally likely, so every
    candidate of a step ties: the beams kept, the tokens they take and
    the hypothesis picked at the end follow the lower index, as in JAX
    (the longest hypotheses win on the length normalisation)."""
    tree = init_flax_layout(CFG_T, 1)
    tree["params"]["decoder"]["lm_head"]["kernel"][:] = 0.0
    (jt, jl, jc), (tt, tl, tc) = _both(tree, _crops(2, n=3), 5)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-5)
    assert (tl == CFG_T.decoder.max_len).all()


def _page(seed: int, h: int = 96, w: int = 128) -> np.ndarray:
    rng = np.random.default_rng(seed)
    page = np.full((h, w), 255, np.uint8)
    for _ in range(5):
        ww, th = int(rng.integers(16, 40)), int(rng.integers(8, 14))
        x, y = int(rng.integers(4, w - ww - 4)), int(rng.integers(4, h - th - 4))
        page[y:y + th, x:x + ww:3] = int(rng.integers(0, 90))
    return page


def test_trocr_processor_beam_matches_jax():
    """``TrOcrProcessor(beam_size=5)``: word boxes of a device page
    (grayscale through K1's plain version on the CPU, and RGB) and host
    fragments in three width buckets read JAX's texts, confidences
    within 1e-5; ``warmup`` runs the beam."""
    tree = _tree(9, 2.0)
    jproc = JaxTrOcrProcessor(config=CFG_J, params=jax.tree_util.tree_map(jnp.asarray, tree),
                              beam_size=5, batch_sizes=(4, 8))
    proc = TrOcrProcessor(CFG_T, tree, beam_size=5, batch_sizes=(4, 8), device="cpu")
    proc.warmup(page_hw=(96, 128), batch_sizes=(4,))
    page = _page(1)
    rgb = np.stack([page, page // 2, 255 - page // 3], -1)
    boxes = np.asarray([[4, 4, 40, 14], [50, 20, 60, 12], [0, 60, 128, 30], [10, 40, 8, 8],
                        [70, 70, 20, 20]], np.float32)
    for dev_page in (page, rgb):
        want = jproc.recognize_collect(jproc.recognize_dispatch(
            jnp.asarray(dev_page if dev_page.ndim == 3 else np.repeat(dev_page[..., None], 3, -1)),
            boxes))
        got = proc.recognize_collect(proc.recognize_dispatch(torch.from_numpy(dev_page), boxes))
        assert [w["text"] for w in got] == [w["text"] for w in want]
        np.testing.assert_allclose([w["confidence"] for w in got],
                                   [w["confidence"] for w in want], rtol=0, atol=1e-5)
    frags = [page[4:18, 4:44], page[0:30, 0:128], rgb[40:60, 10:30], page[70:90, 60:100]]
    want = jproc.recognize_from_fragments(frags)
    got = proc.recognize_from_fragments(frags)
    assert [w["text"] for w in got] == [w["text"] for w in want]
    np.testing.assert_allclose([w["confidence"] for w in got], [w["confidence"] for w in want],
                               rtol=0, atol=1e-5)
    assert any(w["text"] for w in got)
    with pytest.raises(ValueError):
        TrOcrProcessor(CFG_T, tree, beam_size=0, device="cpu")
