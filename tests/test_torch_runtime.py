"""The port's runtime glue on the CPU: ``mesh="local"`` on one device is
no mesh (the JAX engine's result dicts, and the same as ``mesh=None``),
while a mesh object or more cards is refused; ``TimeContextTPU`` and
``profiling`` (``logging_core/profile.py``); ``get_full_version``
(``helper.py``); and ``collect_system_metrics``
(``metrics/system_metrics.py``), whose ``/proc`` figures are held to
psutil's (memory within 2% of the total, the resident set within 16 MiB,
threads equal) and whose keys are the JAX function's.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft as JaxBoxProcessorCraft
from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor as JaxTrOcrProcessor
from marie_tpu.models import configs as jcfg
from marie_tpu.ocr.ocr_engine import PipelineOcrEngine as JaxEngine
from marie_tpu.preprocess import BucketSpec as JaxBucketSpec
from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
from marie_tpu_torch.helper import get_full_version
from marie_tpu_torch.logging_core.profile import TimeContext, TimeContextTPU, profiling
from marie_tpu_torch.metrics import collect_system_metrics
from marie_tpu_torch.metrics import system_metrics as tsm
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.registry.convert import init_flax_layout
from marie_tpu_torch.utils.device import resolve_mesh

H, W = 256, 384
MEM_PERCENT_SLACK = 2.0
RSS_SLACK = 16 << 20


def _pages(n):
    rng = np.random.default_rng(5)
    pages = np.full((n, H, W), 255, np.uint8)
    for p in range(n):
        for _ in range(3):
            x, y = int(rng.integers(8, W - 100)), int(rng.integers(8, H - 30))
            pages[p, y:y + 16, x:x + int(rng.integers(30, 90)):3] = int(rng.integers(0, 90))
    return pages


def test_mesh_local_is_no_mesh_on_one_device():
    """On the CPU ``mesh="local"`` gives the result dicts of
    ``mesh=None``, whose words are the JAX engine's without a mesh (the
    JAX tests run on 8 virtual CPU devices, where the JAX engine's
    ``"local"`` builds a mesh)."""
    craft_tree = init_flax_layout(tcfg.CraftConfig.tiny(), 7)
    trocr_tree = init_flax_layout(tcfg.TrOCRConfig.tiny(), 8)
    buckets = ((H, W),)
    tbp = BoxProcessorCraft(tcfg.CraftConfig.tiny(), craft_tree, box_source="ink",
                            max_components=64, bucket_spec=BucketSpec(shapes=buckets),
                            device="cpu")
    top = TrOcrProcessor(tcfg.TrOCRConfig.tiny(), trocr_tree, batch_sizes=(8, 32),
                         device="cpu")
    pages = list(_pages(2))
    local = PipelineOcrEngine(tbp, top, mesh="local")
    assert local.mesh is None
    got = local.extract(pages)
    assert got == PipelineOcrEngine(tbp, top).extract(pages)
    jbp = JaxBoxProcessorCraft(
        config=jcfg.CraftConfig.tiny(), box_source="ink", max_components=64,
        variables=jax.tree_util.tree_map(jnp.asarray, craft_tree),
        bucket_spec=JaxBucketSpec(shapes=buckets))
    jop = JaxTrOcrProcessor(config=jcfg.TrOCRConfig.tiny(), batch_sizes=(8, 32),
                            params=jax.tree_util.tree_map(jnp.asarray, trocr_tree))
    want = JaxEngine(jbp, jop).extract(pages)
    assert [[w["text"] for w in r["words"]] for r in got] == [
        [w["text"] for w in r["words"]] for r in want]
    assert sum(len(r["words"]) for r in got) > 0


def test_mesh_refusals_name_item_9(monkeypatch):
    """``resolve_mesh`` takes what the JAX engine takes: None and
    ``"local"`` on one device are no mesh, ``"local"`` over several cards
    is a local mesh over each card once, a port mesh is itself; any other
    object or string raises ``TypeError``."""
    from marie_tpu_torch.parallel import Mesh, create_mesh

    assert resolve_mesh(None, "cpu") is None
    assert resolve_mesh("local", "cpu") is None
    mesh = create_mesh((2,), ("pages",), devices=["cpu", "cpu"])
    assert resolve_mesh(mesh, "cpu") is mesh
    with pytest.raises(TypeError, match="mesh must be"):
        resolve_mesh(object(), "cpu")
    with pytest.raises(TypeError, match="mesh must be"):
        resolve_mesh("pages", "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_mesh("local", "cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    local = resolve_mesh("local", "cuda")
    assert isinstance(local, Mesh) and local.shape == {"pages": 4}
    assert local.local_devices == [torch.device("cuda", i) for i in range(4)]


def test_time_context_tpu_on_cpu_tensors(monkeypatch):
    """CPU outputs need no wait: no CUDA synchronise is called, the time
    is kept, and an exception in the block skips the wait and propagates."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    with TimeContextTPU("cpu work", outputs_fn=lambda: [torch.ones(3), {"x": torch.ones(2)}]) \
            as t:
        time.sleep(0.01)
    assert calls == [] and t.duration >= 0.01
    with pytest.raises(ValueError):
        with TimeContextTPU("fails", outputs_fn=lambda: 1 / 0):
            raise ValueError("inside")
    with TimeContextTPU("no outputs"):
        pass
    assert issubclass(TimeContextTPU, TimeContext)


def test_time_context_tpu_waits_on_each_card(monkeypatch):
    """Each CUDA device among the outputs is synchronised once (device
    tensors stood in by objects with a CUDA ``device``)."""
    from marie_tpu_torch.logging_core import profile

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append(dev))
    devs = {torch.device("cuda", 0), torch.device("cuda", 1)}
    monkeypatch.setattr(profile, "_cuda_devices", lambda outputs: devs)
    with TimeContextTPU("card work", outputs_fn=lambda: []):
        pass
    assert sorted(calls, key=str) == sorted(devs, key=str)
    monkeypatch.undo()
    assert profile._cuda_devices([torch.ones(1), (torch.ones(2),), {"a": 3}]) == set()


def test_profiling_logs_and_keeps_the_result(monkeypatch):
    from marie_tpu_torch.logging_core import profile

    lines = []
    monkeypatch.setattr(profile.default_logger, "debug", lines.append)

    @profiling
    def add(a, b=1):
        return a + b

    assert add(2, b=3) == 5 and add.__name__ == "add"
    assert len(lines) == 1 and "add took" in lines[0]


def test_get_full_version_never_raises(monkeypatch):
    info = get_full_version()
    assert info["torch"] == torch.__version__
    assert info["cuda"] == torch.version.cuda
    assert info["marie_tpu_torch"] == "0.1.0"
    if not torch.cuda.is_available():
        assert info["device_count"] == 0 and info["device"] == "unavailable"

    def boom(*a):
        raise RuntimeError("no CUDA runtime")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", boom)
    info = get_full_version()
    assert info["device"] == "unavailable" and info["python"]


def test_system_metrics_match_psutil():
    psutil = pytest.importorskip("psutil")
    from marie_tpu.metrics.system_metrics import collect_system_metrics as jax_collect

    keep = [bytearray(8 << 20)]  # some resident memory of our own
    stop = threading.Event()
    worker = threading.Thread(target=stop.wait)
    worker.start()
    try:
        collect_system_metrics()
        got = collect_system_metrics()
        vm = psutil.virtual_memory()
        proc = psutil.Process()
        rss, threads = proc.memory_info().rss, proc.num_threads()
    finally:
        stop.set()
        worker.join()
    del keep
    want_keys = set(jax_collect()) - {"device.bytes_in_use"}
    assert set(got) == want_keys
    assert abs(got["system.memory_percent"] - vm.percent) <= MEM_PERCENT_SLACK
    assert abs(got["system.memory_available_bytes"] - vm.available) <= (
        MEM_PERCENT_SLACK / 100 * vm.total)
    assert abs(got["process.memory_rss_bytes"] - rss) <= RSS_SLACK
    assert got["process.num_threads"] == threads
    assert 0.0 <= got["system.cpu_percent"] <= 100.0


def test_system_metrics_cpu_percent_and_the_card(monkeypatch):
    """The busy share between two calls from ``/proc/stat``; the card's
    allocated bytes appear where a card is present."""
    ticks = iter([(100, 1000), (160, 1100)])
    monkeypatch.setattr(tsm, "_cpu_times", lambda: next(ticks))
    monkeypatch.setattr(tsm, "_LAST_CPU", None)
    assert tsm._cpu_percent() == 0.0
    assert tsm._cpu_percent() == 60.0
    monkeypatch.setattr(tsm, "_cpu_times", lambda: (160, 1100))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 4096)
    assert collect_system_metrics()["device.bytes_in_use"] == 4096.0
