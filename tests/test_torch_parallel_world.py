"""The port's world legs (``marie_tpu_torch/parallel/``) against the JAX
package's on the same seeded inputs: the dp x tp training step on worlds
(2, 2) and (4, 1), the pipeline, expert and sequence legs, and
``initialize_distributed`` under the JAX environment names.

The port runs in one spawned world of 4 gloo ranks on the CPU that runs
every case (``tests/torch_parallel_ranks.py``, which imports no JAX); the
JAX side runs here on ``tests/conftest.py``'s virtual CPU devices.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from marie_tpu.models import configs as jcfg
from marie_tpu.models.trocr import TrOCRModel as JaxTrOCR
from marie_tpu.parallel import create_mesh as jax_create_mesh
from marie_tpu.parallel import make_train_step as jax_make_train_step
from marie_tpu.parallel.moe import make_moe_fn as jax_make_moe_fn
from marie_tpu.parallel.pipeline import make_pipelined_fn as jax_make_pipelined_fn
from marie_tpu.parallel.sequence import make_seq_attention_fn as jax_make_seq_attention_fn
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.parallel.distributed import spawn_world
from marie_tpu_torch.parallel.check import resolved_share, step_masks
from tests import torch_parallel_ranks as ranks

WORLD = 4
LOSS_TOL = 1e-5
PARAM_TOL = 1e-5  # of each leaf's largest magnitude
TRAIN_KW = dict(
    encoder=dict(image_size=(32, 64), patch_size=16, hidden_dim=128, num_layers=2,
                 num_heads=2, mlp_dim=512, use_cls_token=False),
    decoder=dict(vocab_size=128, hidden_dim=128, num_layers=2, num_heads=2, mlp_dim=512,
                 max_len=12))
MOE_CAPACITIES = (32, 2)  # ample (nothing drops), and tight (tokens drop)
GRAD_NOISE = 1e-5  # of a leaf's largest gradient: JAX's against the port's
GRAD_TOL = 1e-4  # the sharded step's gradients against the one-rank step's
LR = 1e-4  # optax.adamw(1e-4)


def _configs():
    return (jcfg.TrOCRConfig(encoder=jcfg.ViTConfig(**TRAIN_KW["encoder"]),
                             decoder=jcfg.DecoderConfig(**TRAIN_KW["decoder"])),
            tcfg.TrOCRConfig(encoder=tcfg.ViTConfig(**TRAIN_KW["encoder"]),
                             decoder=tcfg.DecoderConfig(**TRAIN_KW["decoder"])))


def _jax_expert(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _train_batch():
    rng = np.random.default_rng(40)
    images = rng.random((8, 32, 64, 3)).astype(np.float32)
    tokens = rng.integers(3, 128, (8, 12)).astype(np.int32)
    tokens[:, 0] = 0
    for i, n in enumerate((12, 9, 5, 12, 7, 3, 10, 11)):  # EOS, then pads
        tokens[i, n - 1] = 1
        tokens[i, n:] = 2
    return images, tokens


def _jax_mesh(shape, axes):
    return JaxMesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)


@pytest.fixture(scope="module")
def cases():
    """The JAX side of every case, and the port's outputs from one world
    of 4 ranks (rank 0's; every rank's are checked equal)."""
    jc, tc = _configs()
    images, tokens = _train_batch()
    model = JaxTrOCR(jc)
    jax_train = {}
    tree = None
    for shape in ((2, 2), (4, 1)):
        mesh = jax_create_mesh(shape, devices=jax.devices()[:4])
        with mesh:
            init_fn, step_fn = jax_make_train_step(model, mesh)
            params, opt_state = init_fn(jax.random.PRNGKey(0), jnp.asarray(images),
                                        jnp.asarray(tokens))
            if tree is None:
                tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                              jax.device_get(params))
            im, tk = step_fn.place_batch(jnp.asarray(images), jnp.asarray(tokens))
            losses = []
            for _ in range(ranks.TRAIN_STEPS):
                params, opt_state, loss = step_fn(params, opt_state, im, tk)
                losses.append(float(loss))
        jax_train[shape] = (losses, jax.device_get(params))
    rng = np.random.default_rng(3)
    payload = {"train": (tc, tree, images, tokens)}
    for shape in ((4,), (2, 2)):
        stages, data = shape[-1], (shape[0] if len(shape) == 2 else 1)
        payload[("pipeline", shape)] = (
            (rng.normal(size=(stages, 16, 16)).astype(np.float32) * 0.3,
             rng.normal(size=(stages, 16)).astype(np.float32) * 0.1),
            rng.normal(size=(6 * data, 4, 16)).astype(np.float32))
        experts = shape[-1]
        payload[("moe", shape)] = {
            cap: ((rng.normal(size=(experts, 16, 16)).astype(np.float32) * 0.3,
                   rng.normal(size=(experts, 16)).astype(np.float32) * 0.1),
                  rng.normal(size=(16, experts)).astype(np.float32),
                  rng.normal(size=(8 * data, 16)).astype(np.float32))
            for cap in MOE_CAPACITIES}
    payload["seq"] = tuple(rng.normal(size=(2, 32, 4, 8)).astype(np.float32) for _ in range(3))
    got = spawn_world(ranks.world_cases, WORLD, args=(payload,), device="cpu", timeout_s=120)
    return {"jax_train": jax_train, "payload": payload, "ranks": got, "port": got[0],
            "one_rank": ranks.train_case((1, 1), tc, tree, images, tokens)}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree, np.float64)


def masks(grad_trees, params, tol, noise=None):
    """(live leaves, resolved elements) of :func:`step_masks`: a gradient
    error of ``noise`` (default ``GRAD_NOISE``) of a leaf's largest moves
    AdamW's parameter by at most half of ``tol`` where it resolves."""
    return step_masks(grad_trees, params, tol, noise=noise or GRAD_NOISE, lr=LR)


def _assert_trees_close(got, want, tol, where=None):
    """Every leaf within ``tol`` of its largest magnitude (on ``where``'s
    elements where given: a mask, or one bool for the whole leaf)."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        diff = np.abs(got[path] - w)
        if where is not None:
            diff = diff[np.broadcast_to(np.asarray(where[path]), diff.shape)]
        err = float(diff.max()) if diff.size else 0.0
        assert err <= tol * scale, (path, err, scale)


def test_ranks_agree(cases):
    """Every rank returns the same outputs (the collectives leave every
    rank the whole result), and the world's stream bounds split 10 items."""
    port = cases["port"]
    assert [r["bounds"] for r in cases["ranks"]] == [(0, 3), (3, 6), (6, 9), (9, 10)]
    for other in cases["ranks"][1:]:
        for key, value in port.items():
            if key in ("rank", "bounds"):
                continue
            if key[0] == "train":
                assert other[key][0] == value[0]
                for a, b in zip(other[key][3] + [other[key][1]], value[3] + [value[1]]):
                    _assert_trees_close(a, b, 0.0)
            else:
                np.testing.assert_array_equal(other[key], value, err_msg=str(key))


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_train_step_matches_jax(cases, shape):
    """Losses within 1e-5 and parameters within 1e-5 of each leaf's
    largest where the gradient resolves (:func:`masks`, from the
    port's one-rank gradients) after 2 steps of AdamW from one
    JAX-initialised tree; the loss falls; the model axis shards what the
    JAX rule shards."""
    want_losses, want_params = cases["jax_train"][shape]
    losses, tree, sharded, _ = cases["port"][("train", shape)]
    live, where = masks(cases["one_rank"][3], want_params, PARAM_TOL)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_TOL)
    assert losses[1] < losses[0]
    _assert_trees_close(tree, want_params, PARAM_TOL, where)
    assert resolved_share(live, where) > 0.5
    assert bool(sharded) == (shape[1] > 1)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_sharded_step_equals_one_rank(cases, shape):
    """The sharded step is the one-rank step's function: losses within
    1e-6, each step's gradients within ``GRAD_TOL`` of each leaf's
    largest (the sums over ranks run in another order; a gradient that
    is zero in exact arithmetic, a key bias's, is float32 noise and not
    compared), and parameters within 1e-6 of each leaf's largest where a
    gradient error of ``GRAD_TOL`` cannot move them by more."""
    one_losses, one_tree, one_sharded, one_grads = cases["one_rank"]
    losses, tree, _, grads = cases["port"][("train", shape)]
    assert one_sharded == []
    np.testing.assert_allclose(losses, one_losses, rtol=0, atol=1e-6)
    live, where = masks(one_grads, one_tree, 1e-6, GRAD_TOL)
    for got, want in zip(grads, one_grads):
        _assert_trees_close(got, want, GRAD_TOL, live)
    _assert_trees_close(tree, one_tree, 1e-6, where)


@pytest.mark.parametrize("shape,axes", [((4,), ("pipe",)), ((2, 2), ("data", "pipe"))])
def test_pipeline_matches_jax(cases, shape, axes):
    params, batch = cases["payload"][("pipeline", shape)]
    want = jax_make_pipelined_fn(_jax_mesh(shape, axes), _jax_expert)(
        tuple(jnp.asarray(p) for p in params), jnp.asarray(batch))
    np.testing.assert_allclose(cases["port"][("pipeline", shape)], np.asarray(want),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,axes", [((4,), ("expert",)), ((2, 2), ("data", "expert"))])
@pytest.mark.parametrize("capacity", MOE_CAPACITIES)
def test_moe_matches_jax(cases, shape, axes, capacity):
    """Outputs within 1e-5; the dropped tokens (all-zero outputs) are the
    same ones."""
    params, router, x = cases["payload"][("moe", shape)][capacity]
    want = np.asarray(jax_make_moe_fn(_jax_mesh(shape, axes), _jax_expert, capacity=capacity)(
        tuple(jnp.asarray(p) for p in params), jnp.asarray(router), jnp.asarray(x)))
    got = cases["port"][("moe", shape, capacity)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    dropped = ~np.any(want != 0, axis=1)
    np.testing.assert_array_equal(~np.any(got != 0, axis=1), dropped)
    assert dropped.any() == (capacity < 8)


def test_sequence_attention_matches_jax(cases):
    q, k, v = cases["payload"]["seq"]
    want = jax_make_seq_attention_fn(_jax_mesh((4,), ("seq",)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(cases["port"]["seq"], np.asarray(want), rtol=0, atol=1e-5)


def test_initialize_distributed_from_jax_env(tmp_path):
    """Two processes join one world from JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID: each takes half of 10 items and
    the world's sum of its blocks is 24, as the JAX package's two-process
    test finds."""
    store = os.path.join(tmp_path, "store")
    env = {0: None, 1: None}
    for r in env:
        env[r] = {"JAX_COORDINATOR_ADDRESS": f"file://{store}", "JAX_NUM_PROCESSES": "2",
                  "JAX_PROCESS_ID": str(r)}
    got = spawn_world(ranks.jax_env_case, 2, init=False, env=env.__getitem__, device="cpu",
                      timeout_s=60)
    assert got == [(True, (0, 5), 24.0), (True, (5, 10), 24.0)]
