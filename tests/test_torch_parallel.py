"""The port's meshes on one process (``marie_tpu_torch/parallel/``, and the
mesh on the serving path) against the JAX package on the same seeded
inputs: the sharding rule, ``shard_batch``, the teacher-forced TrOCR
forward, ``fused_ocr_pages`` and ``fused_ocr_chain`` over a local mesh of
4 CPU entries, the engine with ``mesh=``, and ``dryrun_multichip(4)``.
The JAX side runs on ``tests/conftest.py``'s virtual CPU devices."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft as JaxBoxProcessorCraft
from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor as JaxTrOcrProcessor
from marie_tpu.models import configs as jcfg
from marie_tpu.models.trocr import TrOCRModel as JaxTrOCR
from marie_tpu.ocr.fused import fused_ocr_pages as jax_fused_ocr_pages
from marie_tpu.ocr.fused_chain import fused_ocr_chain as jax_fused_ocr_chain
from marie_tpu.parallel import create_mesh as jax_create_mesh
from marie_tpu.parallel import infer_param_sharding as jax_infer_param_sharding
from marie_tpu.parallel import shard_batch as jax_shard_batch
from marie_tpu.preprocess import BucketSpec as JaxBucketSpec
from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.ocr import fused as tfused
from marie_tpu_torch.ocr.fused import fused_ocr_pages
from marie_tpu_torch.ocr.fused_chain import fused_ocr_chain
from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
from marie_tpu_torch.parallel import Mesh, create_mesh, infer_param_sharding, shard_batch
from marie_tpu_torch.parallel.distributed import host_shard_bounds
from marie_tpu_torch.parallel.dryrun import dryrun_multichip
from marie_tpu_torch.parallel.sharding import param_shards, shard_of
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.registry.convert import build_model, from_flax, init_flax_layout
from tests.test_torch_chain import _heads

ENTRIES = 4
WIDE = dict(
    encoder=dict(image_size=(32, 64), patch_size=16, hidden_dim=128, num_layers=2,
                 num_heads=2, mlp_dim=512, use_cls_token=False),
    decoder=dict(vocab_size=128, hidden_dim=128, num_layers=2, num_heads=2, mlp_dim=512,
                 max_len=12, cross_kv_heads=1))


def _wide():
    """A TrOCR whose leaves cross 2**14 (hidden 128, mlp 512; grouped
    cross K/V), as (JAX config, port config)."""
    return (jcfg.TrOCRConfig(encoder=jcfg.ViTConfig(**WIDE["encoder"]),
                             decoder=jcfg.DecoderConfig(**WIDE["decoder"])),
            tcfg.TrOCRConfig(encoder=tcfg.ViTConfig(**WIDE["encoder"]),
                             decoder=tcfg.DecoderConfig(**WIDE["decoder"])))


def _cpu_mesh(n=ENTRIES, axes=("pages",), shape=None):
    return create_mesh(shape or (n,), axes, devices=["cpu"] * n)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_create_mesh_shapes_and_refusals():
    mesh = create_mesh((4, 2), devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8 and not mesh.is_world
    assert create_mesh(devices=["cpu"] * 8).shape == {"data": 8, "model": 1}
    assert create_mesh((2, 2, 2), ("data", "pipe", "expert"), devices=["cpu"] * 8).shape == {
        "data": 2, "pipe": 2, "expert": 2}
    with pytest.raises(ValueError, match="does not cover 8 devices"):
        create_mesh((3, 2), devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        create_mesh((2,), devices=["cpu"] * 2)  # one size for two axes
    with pytest.raises(ValueError, match="world mesh"):
        mesh.group("model")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_mesh()  # every visible card: none here
    assert host_shard_bounds(10) == (0, 10)  # no world: this process takes all


@pytest.mark.parametrize("m", [2, 4])
def test_sharding_rule_matches_jax(m):
    """The (flax path, axis) pairs the port shards are JAX's, and each
    torch block holds exactly the flax leaf's block of its last axis."""
    jc, tc = _wide()
    tree = init_flax_layout(tc, 0)
    specs = jax_infer_param_sharding(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jax_create_mesh((8 // m, m), devices=jax.devices()[:8]))
    want = {path: tuple(s.spec) for path, s in _leaves(specs)}
    mesh = _cpu_mesh(8, ("data", "model"), (8 // m, m))
    got = dict(_leaves(infer_param_sharding(tree, mesh)))
    assert got == want
    sharded = {p for p, spec in want.items() if spec}
    assert len(sharded) > 10
    # the torch side: fill each sharded flax leaf with its last-axis index
    marked = jax.tree_util.tree_map(np.copy, tree)
    for path in sharded:
        node = marked
        for k in path[:-1]:
            node = node[k]
        leaf = node[path[-1]]
        node[path[-1]] = np.broadcast_to(np.arange(leaf.shape[-1], dtype=np.float32),
                                         leaf.shape).copy()
    module = from_flax(marked, build_model(tc))
    shards = param_shards(module, mesh)
    assert {("params",) + s.flax_path for s in shards.values()} == sharded
    params = dict(module.named_parameters())
    for name, shard in shards.items():
        width = shard.view[shard.dim] // m
        for i in range(m):
            block = shard_of(params[name].detach(), shard, i, m)
            assert set(np.unique(block.numpy())) == set(range(i * width, (i + 1) * width)), name


def test_nothing_sharded_at_one_model_rank():
    _, tc = _wide()
    tree = init_flax_layout(tc, 0)
    mesh = _cpu_mesh(8, ("data", "model"), (8, 1))
    assert not any(spec for _, spec in _leaves(infer_param_sharding(tree, mesh)))
    assert param_shards(build_model(tc), mesh) == {}


def test_shard_batch_matches_jax():
    """Each entry's block is the block JAX places on its device; 0-d
    leaves are whole everywhere."""
    jmesh = jax_create_mesh((4, 2), devices=jax.devices()[:8])
    mesh = _cpu_mesh(8, ("data", "model"), (4, 2))
    x = np.arange(16 * 3 * 2, dtype=np.float32).reshape(16, 3, 2)
    placed = jax.device_put(jnp.asarray(x), jax_shard_batch(jmesh)(x))
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    want = [by_device[d] for d in jmesh.devices.reshape(-1)]
    got = shard_batch(mesh)(x)
    assert len(got) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert [float(t) for t in shard_batch(mesh)(np.float32(3.0))] == [3.0] * 8
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(mesh)(np.zeros((6, 2)))


def test_teacher_forced_forward_matches_jax():
    """TrOCRModel.forward (the training step's model) equals JAX's
    ``apply(params, images, tokens)`` within 1e-5."""
    jc, tc = _wide()
    tree = init_flax_layout(tc, 3)
    rng = np.random.default_rng(5)
    images = rng.random((3, 32, 64, 3)).astype(np.float32)
    tokens = rng.integers(0, 128, (3, 11)).astype(np.int32)
    want = np.asarray(JaxTrOCR(jc).apply(jax.tree_util.tree_map(jnp.asarray, tree),
                                         jnp.asarray(images), jnp.asarray(tokens)))
    model = from_flax(tree, build_model(tc))
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(tokens).long()).numpy()
    assert got.shape == (3, 11, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


SIDE = 64


@pytest.fixture(scope="module")
def tiny():
    """(JAX (bp, op), port (bp, op)) with the same weights: the JAX mesh
    test's tiny CRAFT (ink boxes) and TrOCR on 64x64 pages."""
    craft_tree = init_flax_layout(tcfg.CraftConfig.tiny(), 7)
    trocr_tree = init_flax_layout(tcfg.TrOCRConfig.tiny(), 8)
    jbp = JaxBoxProcessorCraft(
        config=jcfg.CraftConfig.tiny(), box_source="ink", min_area=4, max_components=16,
        bucket_spec=JaxBucketSpec(shapes=((SIDE, SIDE),)),
        variables=jax.tree_util.tree_map(jnp.asarray, craft_tree))
    jop = JaxTrOcrProcessor(config=jcfg.TrOCRConfig.tiny(), beam_size=1, batch_sizes=(16,),
                            params=jax.tree_util.tree_map(jnp.asarray, trocr_tree))
    tbp = BoxProcessorCraft(tcfg.CraftConfig.tiny(), craft_tree, box_source="ink",
                            min_area=4, max_components=16,
                            bucket_spec=BucketSpec(shapes=((SIDE, SIDE),)), device="cpu")
    top = TrOcrProcessor(tcfg.TrOCRConfig.tiny(), trocr_tree, batch_sizes=(16,), device="cpu")
    return (jbp, jop), (tbp, top)


def _blob_pages(n=8):
    """The JAX mesh test's pages: one ink blob a page, growing."""
    pages = np.full((n, SIDE, SIDE), 255, np.uint8)
    for i in range(n):
        pages[i, 20:28 + i, 10:40] = 0
    return pages


def _word_pages(n=8):
    """Pages of 1-4 ink words, so that pages differ in kept boxes."""
    rng = np.random.default_rng(11)
    pages = np.full((n, SIDE, SIDE), 255, np.uint8)
    for i in range(n):
        for j in range(1 + i % 4):
            y, x = 4 + 14 * j, int(rng.integers(2, 20))
            pages[i, y:y + 5, x:x + int(rng.integers(10, 40))] = int(rng.integers(0, 90))
    return pages


def _assert_same_program(got, want):
    """Stats and tokens equal; confidences within 1e-6 (a row's decode
    runs in a smaller batch on its entry)."""
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("pages,kw", [
    (_blob_pages(), dict(compact_slots=4)),
    (_word_pages(), dict(compact_slots=2)),  # rows past the budget
    (_word_pages(), dict(compact_slots=4, n_real=6)),  # ladder-padding pages
    (_word_pages()[..., None].repeat(3, -1), dict(compact_slots=4)),  # RGB pages
])
def test_fused_pages_mesh_equals_unsharded(tiny, pages, kw):
    """Over a local mesh of 4 CPU entries the rows, tokens and stats are
    the unsharded call's."""
    _, (tbp, top) = tiny
    mesh = _cpu_mesh()
    want = fused_ocr_pages(tbp, top, pages, **kw)
    got = fused_ocr_pages(tbp, top, pages, mesh=mesh, **kw)
    assert int(want[0]["valid"].sum()) > 0
    _assert_same_program(got, want)
    assert len(tbp._mesh_model_cache) == 1  # replicated once per mesh
    fused_ocr_pages(tbp, top, pages, mesh=_cpu_mesh(), **kw)
    assert len(tbp._mesh_model_cache) == 1


def test_fused_pages_mesh_matches_jax_mesh(tiny):
    """The port's sharded call against JAX's sharded call over 4 devices:
    stats and tokens equal, confidences within 1e-3 (the port's
    unsharded parity tests' limits)."""
    (jbp, jop), (tbp, top) = tiny
    pages = _blob_pages()
    jmesh = JaxMesh(np.asarray(jax.devices()[:ENTRIES]), ("pages",))
    with jmesh:
        want = jax.device_get(jax_fused_ocr_pages(jbp, jop, pages, mesh=jmesh,
                                                  compact_slots=4))
    got = fused_ocr_pages(tbp, top, pages, mesh=_cpu_mesh(), compact_slots=4)
    for field in ("boxes", "areas", "scores", "valid", "stride"):
        np.testing.assert_array_equal(got[0][field].numpy(), np.asarray(want[0][field]),
                                      err_msg=field)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-3)


def test_fused_pages_mesh_refusals(tiny):
    _, (tbp, top) = tiny
    with pytest.raises(ValueError, match="not divisible by mesh devices 4"):
        fused_ocr_pages(tbp, top, _blob_pages(6), mesh=_cpu_mesh())
    with pytest.raises(TypeError, match="mesh must be"):
        fused_ocr_pages(tbp, top, _blob_pages(4), mesh=object())
    assert torch.equal(fused_ocr_pages(tbp, top, _blob_pages(4), mesh="local")[1],
                       fused_ocr_pages(tbp, top, _blob_pages(4))[1])  # no mesh on the CPU


def test_fused_chain_mesh(tiny):
    """The chained program over 4 entries: equal to the unsharded call
    (logits within 1e-5, NER labels equal), and to JAX's sharded call as
    the port's chain parity test holds it."""
    (jbp, jop), (tbp, top) = tiny
    (jcls, jner), (tcls, tner) = _heads(16)
    pages = _word_pages()
    mesh = _cpu_mesh()
    want = fused_ocr_chain(tbp, top, tcls, tner, pages, compact_slots=4)
    got = fused_ocr_chain(tbp, top, tcls, tner, pages, compact_slots=4, mesh=mesh)
    _assert_same_program(got[:3], want[:3])
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-5)
    assert torch.equal(got[4], want[4])
    torch.testing.assert_close(got[5], want[5], rtol=0, atol=1e-5)
    jmesh = JaxMesh(np.asarray(jax.devices()[:ENTRIES]), ("pages",))
    with jmesh:
        jw = jax.device_get(jax_fused_ocr_chain(jbp, jop, jcls, jner, pages, mesh=jmesh,
                                                compact_slots=4))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jw[1]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(jw[3]), atol=1e-5)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(jw[4]))


def test_engine_mesh_results_equal(tiny):
    """``PipelineOcrEngine(mesh=...)`` gives the result dicts of the
    engine without a mesh; a group whose padded size does not divide by
    the entries (the tail of 6 pages in groups of 4: 2 pages) runs whole,
    and the counter says so."""
    _, (tbp, top) = tiny
    frames = list(_word_pages(6))
    want = PipelineOcrEngine(tbp, top, page_fuse_batch=4, compact_slots=4).extract(frames)
    before = dict(tfused.MESH_GROUPS)
    engine = PipelineOcrEngine(tbp, top, page_fuse_batch=4, compact_slots=4, mesh=_cpu_mesh())
    assert isinstance(engine.mesh, Mesh)
    got = engine.extract(frames)
    assert tfused.MESH_GROUPS["sharded"] - before["sharded"] == 1
    assert tfused.MESH_GROUPS["unsharded"] - before["unsharded"] == 1

    def plain(results):
        return [[{k: v for k, v in w.items() if k != "confidence"} for w in r["words"]]
                for r in results]

    assert plain(got) == plain(want) and sum(len(r["words"]) for r in got) > 0
    np.testing.assert_allclose([w["confidence"] for r in got for w in r["words"]],
                               [w["confidence"] for r in want for w in r["words"]], atol=1e-6)


def test_dryrun_multichip_cpu(capsys):
    out = dryrun_multichip(ENTRIES, device="cpu")
    assert out["train"]["mesh"] == [2, 2] and np.isfinite(out["train"]["loss"])
    for leg in ("pipeline", "moe", "seq", "overlay"):
        assert out[leg]["max_abs_err"] <= 1e-5, leg
    assert out["serve"]["tokens"] == [8 * 4, 8]  # 8 pages of 4 rows, 8 decode steps
    printed = capsys.readouterr().out
    for leg in ("train", "serve", "pipeline", "moe", "seq", "chain", "overlay"):
        assert f"dryrun_multichip {leg} ok" in printed
