"""marie_tpu_torch and chip_smoke.py stand alone: they import neither JAX
(nor flax, orbax, PIL, cv2, pydantic, grpc, protobuf, aiohttp, PyYAML,
psycopg2, prometheus_client, etcd3, opentelemetry) nor anything of the JAX
package."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "marie_tpu_torch"

#: modules the card's machine does not have
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "orbax.checkpoint", "PIL", "cv2", "pydantic",
           "grpc", "google.protobuf", "aiohttp", "yaml", "psycopg2", "prometheus_client", "etcd3",
           "opentelemetry")

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
for name in BLOCKED:
    sys.modules[name] = None  # any import of these now raises ImportError
assert not any(m == "marie_tpu" or m.startswith("marie_tpu.") for m in sys.modules)
import marie_tpu_torch
names = [m.name for m in pkgutil.walk_packages(marie_tpu_torch.__path__, "marie_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m == "marie_tpu" or m.startswith("marie_tpu."))
assert not leaked, leaked
print(len(names))
"""


def test_package_imports_with_jax_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", f"BLOCKED = {BLOCKED!r}\n" + _BLOCKED_IMPORT],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


def test_no_jax_or_marie_tpu_imports_in_sources():
    # psycopg2 is left out: the postgres storage imports it where it is
    # asked for (executor/storage.py), as the JAX package does
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|orbax|PIL|cv2|pydantic|grpc|google\.protobuf"
        r"|aiohttp|yaml|marie_tpu)(\.|\s|$)",
        re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        text = path.read_text()
        assert not pattern.search(text), path
        assert "marie_tpu." not in re.sub(r"marie_tpu_torch", "", text).replace(
            "marie_tpu/", ""), path


def test_importing_the_package_builds_nothing():
    out = subprocess.run(
        [sys.executable, "-c",
         "import marie_tpu_torch.ocr.ocr_engine, marie_tpu_torch.ops.kernels._build as b;"
         "print(b._LIBS)"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "{}"


_NEW_MODULES = r"""
import sys
for name in ("jax", "jaxlib", "flax", "orbax", "orbax.checkpoint", "PIL", "cv2"):
    sys.modules[name] = None
from marie_tpu_torch.components.document_registration import DocumentBoundaryRegistration
from marie_tpu_torch.components.template_matching import (
    CompositeTemplateMatcher, DIMTemplateMatcher, NCCTemplateMatcher, OcrConditionedMatcher,
    VQNNFTemplateMatcher)
from marie_tpu_torch.models.boundary import BoundaryNet, warp_quad_to_page
from marie_tpu_torch.ops.nms import batched_nms, nms
from marie_tpu_torch.ops.box_ops import box_iou
reg = DocumentBoundaryRegistration(use_model=False, device="cpu")
m = NCCTemplateMatcher(device="cpu")
m.add_template("t", __import__("numpy").zeros((4, 4), "uint8"))
print(reg.model is None, len(m.match([__import__("numpy").full((16, 16), 255, "uint8")])))
"""


def test_registration_and_matching_import_with_jax_blocked():
    """The boundary and template-matching modules import and run (on the
    CPU) with JAX, flax, orbax, PIL and cv2 blocked."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _NEW_MODULES], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["True", "0"]


def test_pipeline_and_embeddings_default_to_the_card():
    """The classification pipeline and the layout embeddings are the
    port's; the embeddings (like the heads the pipeline runs) are built on
    the card unless the caller asks for the CPU, and refuse where CUDA is
    absent rather than fall back."""
    import inspect

    import pytest
    import torch

    from marie_tpu_torch.embeddings import LayoutEmbeddingsModel
    from marie_tpu_torch.models.configs import LayoutLMConfig
    from marie_tpu_torch.pipe import ClassificationPipeline

    assert inspect.signature(LayoutEmbeddingsModel).parameters["device"].default == "cuda"
    assert callable(ClassificationPipeline.execute)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            LayoutEmbeddingsModel(LayoutLMConfig.tiny())


_DETECTORS = r"""
import sys
for name in ("jax", "jaxlib", "flax", "orbax", "orbax.checkpoint", "PIL", "cv2"):
    sys.modules[name] = None
import numpy as np
from marie_tpu_torch.boxes import (
    BoxProcessorTextFuseNet, BoxProcessorUlimDit, InkBoxProcessor)
from marie_tpu_torch.boxes.craft_box_processor import CC_STATS
from marie_tpu_torch.models.configs import TextFuseNetConfig, ViTConfig
from marie_tpu_torch.ops.roi_align import roi_align, roi_align_single
page = np.full((64, 48), 255, np.uint8)
page[20:30, 8:40] = 0
ink = InkBoxProcessor(device="cpu", bucket_spec=None)
print(len(ink.detect_words(page)[0]), sorted(CC_STATS))
"""


def test_detectors_import_with_jax_blocked():
    """The ink, DiT and TextFuseNet detectors, ROIAlign and the CC stats
    variants import (and the ink detector runs on the CPU) with JAX,
    flax, orbax, PIL and cv2 blocked."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _DETECTORS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[0] == "1 ['reduce', 'reduce2', 'runs', 'runs_cc', 'sort']"


def test_detectors_default_to_the_card():
    """Each new detector, ROIAlign and the page-resident engine path run
    on the card unless the caller asks for the CPU, and refuse where CUDA
    is absent rather than fall back."""
    import inspect

    import pytest
    import torch

    from marie_tpu_torch.boxes import (
        BoxProcessorTextFuseNet, BoxProcessorUlimDit, InkBoxProcessor)
    from marie_tpu_torch.ops.roi_align import roi_align, roi_align_single

    entries = (InkBoxProcessor, BoxProcessorUlimDit, BoxProcessorTextFuseNet, roi_align,
               roi_align_single)
    for fn in entries:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            InkBoxProcessor()
        with pytest.raises(RuntimeError):
            roi_align_single(torch.zeros(1, 4, 4), torch.zeros(1, 4))


_SLICE_12 = r"""
import sys
for name in ("jax", "jaxlib", "flax", "orbax", "orbax.checkpoint", "PIL", "cv2", "psutil"):
    sys.modules[name] = None
import numpy as np
from marie_tpu_torch.document.layoutreader import load_text_layout, reorder_page_result
from marie_tpu_torch.helper import get_full_version
from marie_tpu_torch.logging_core import TimeContextTPU, profiling
from marie_tpu_torch.metrics import collect_system_metrics
from marie_tpu_torch.models.reading_order import ReadingOrderConfig, TextLayout
from marie_tpu_torch.ops.deform_conv import deform_conv2d
from marie_tpu_torch.ops.nms import rotated_nms
from marie_tpu_torch.ops.roi_align import roi_align_rotated
from marie_tpu_torch.ops.rotated_iou import pairwise_rotated_iou
from marie_tpu_torch.utils.image_io import decode_jpeg, encode_g4, read_bmp, read_image
layout = load_text_layout(config=ReadingOrderConfig.tiny(), device="cpu")
print(layout.order([[0, 0, 10, 10], [0, 20, 10, 30]]) in ([0, 1], [1, 0]),
      sorted(collect_system_metrics())[0], "torch" in get_full_version())
"""


def test_slice_12_modules_import_with_jax_blocked():
    """Reading order, the runtime glue, the rotated ops and the new image
    readers import and run on the CPU with JAX, flax, orbax, PIL, cv2 and
    psutil blocked (the host metrics come from ``/proc``)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _SLICE_12], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["True", "process.memory_rss_bytes", "True"]


_SERVING = r"""
import sys
for name in BLOCKED + ("psutil", "prometheus_client"):
    sys.modules[name] = None
import asyncio, json, urllib.request
import numpy as np
from marie_tpu_torch.api.docs import AssetKeyDoc, BatchableMarieDoc, MarieDoc, OutputDoc, StorageDoc
from marie_tpu_torch.auth import auth_enabled, validate_bearer
from marie_tpu_torch.clients import HTTPClient
from marie_tpu_torch.clients.helper import as_docarray, chunk_docs
from marie_tpu_torch.executor import (
    DocumentClassificationExecutor, NerExtractionExecutor, OverlayExecutor,
    TemplateMatchingExecutor, TextExtractionExecutor, TextExtractionExecutorMock)
from marie_tpu_torch.executor.storage import StorageMixin
from marie_tpu_torch.metrics import get_registry, render_prometheus
from marie_tpu_torch.ocr.fused import fused_dispatch, fused_page, fused_pages
from marie_tpu_torch.orchestrate.pods import Pod
from marie_tpu_torch.serve.runtimes.asyncio_runtime import AsyncNewLoopRuntime
from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
from marie_tpu_torch.storage.kv import SqliteKV
from marie_tpu_torch.types import Document

async def main():
    handler = WorkerRequestHandler(uses=TextExtractionExecutorMock, name="mock")
    runtime = AsyncNewLoopRuntime(handler, protocol="http")
    await runtime.server.setup_server()
    client = HTTPClient(port=runtime.server.port)
    page = np.full((32, 32), 255, np.uint8)
    body = await client.apost("/document/extract", [Document(tensor=page)],
                              return_responses=True)
    await runtime.server.shutdown()
    return body

body = asyncio.run(main())
print(body["header"]["status"]["code"], body["parameters"]["__results__"]["mock"]["status"],
      auth_enabled(), "marie_request_seconds" in render_prometheus())
"""


def test_serving_plane_imports_and_serves_with_its_absent_packages_blocked():
    """The documents, the executors, the worker, the HTTP server, the pod,
    the client and the single-page program import with JAX, flax, orbax,
    PIL, cv2, pydantic, grpc, protobuf, aiohttp, PyYAML, psycopg2, psutil
    and prometheus_client blocked, and a worker answers a request over
    HTTP on the CPU."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", f"BLOCKED = {BLOCKED!r}\n" + _SERVING],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["0", "succeeded", "False", "True"]


def test_serving_entry_points_default_to_the_card_and_refuse_what_waits():
    """The executors take ``device`` defaulting to the card; gRPC is the
    default protocol of the runtime, the pods and the client.  WebSocket,
    the cloud HTTP apps, several protocols on one runtime, the monitoring
    port and the WebSocket client build what the JAX package builds for
    them; so do a RAFT pod (``raft``) and a stateful deployment, which no
    longer raise."""
    import inspect

    import pytest

    from marie_tpu.clients import Client as JClient
    from marie_tpu.orchestrate.pods import Pod as JPod
    from marie_tpu.serve.runtimes.asyncio_runtime import AsyncNewLoopRuntime as JRuntime
    from marie_tpu_torch.clients import Client, GRPCClient
    from marie_tpu_torch.executor import (
        DocumentClassificationExecutor, NerExtractionExecutor, OverlayExecutor,
        TemplateMatchingExecutor, TextExtractionExecutor)
    from marie_tpu_torch.orchestrate.deployments import Deployment
    from marie_tpu_torch.orchestrate.pods import Pod
    from marie_tpu_torch.serve.runtimes.asyncio_runtime import AsyncNewLoopRuntime
    from marie_tpu_torch.serve.runtimes.servers import GRPCServer

    for cls in (TextExtractionExecutor, NerExtractionExecutor, DocumentClassificationExecutor,
                OverlayExecutor, TemplateMatchingExecutor):
        assert inspect.signature(cls).parameters["device"].default == "cuda", cls
    assert isinstance(AsyncNewLoopRuntime(None).server, GRPCServer)
    assert isinstance(Client(port=1), GRPCClient)
    assert Pod("gateway").kwargs.get("protocol", "grpc") == "grpc"

    def built(runtime):
        server = runtime.server
        return (type(server).__name__, [type(s).__name__ for s in getattr(server, "servers", [])],
                runtime.port_monitoring)

    for kwargs in ({"protocol": "websocket"}, {"protocol": "sagemaker"}, {"protocol": "azure"},
                   {"protocols": ["http", "grpc"]}, {"protocols": ["grpc", "http", "websocket"]},
                   {"port_monitoring": 9000}):
        assert built(AsyncNewLoopRuntime(None, **kwargs)) == built(JRuntime(None, **kwargs)), \
            kwargs
    for kind, kwargs in (("worker", {"protocol": "websocket"}),
                         ("worker", {"protocols": ["http", "grpc"]}),
                         ("head", {"port_monitoring": 9000})):
        pod, jpod = Pod(kind, **kwargs), JPod(kind, **kwargs)
        assert (pod.kind, pod.name, pod.kwargs) == (jpod.kind, jpod.name, jpod.kwargs), kwargs
    ws, jws = Client(port=1, protocol="websocket"), JClient(port=1, protocol="websocket")
    assert (type(ws).__name__, ws.url) == (type(jws).__name__, jws.url)
    from marie_tpu.orchestrate.deployments import Deployment as JDeployment

    raft = {"node_id": "d-0", "bind_addr": "127.0.0.1:1", "peers": [("d-1", "127.0.0.1:2")]}
    pod, jpod = Pod("worker", raft=raft), JPod("worker", raft=raft)
    assert (pod.kind, pod.name, pod.kwargs) == (jpod.kind, jpod.name, jpod.kwargs)
    dep, jdep = Deployment(stateful=True, replicas=3), JDeployment(stateful=True, replicas=3)
    assert (dep.stateful, dep.replicas) == (jdep.stateful, jdep.replicas) == (True, 3)
    assert len({p.kwargs["raft"]["bind_addr"] for p in dep._worker_pods()}) == 3


_GRPC_SERVING = r"""
import sys
for name in BLOCKED + ("psutil", "prometheus_client"):
    sys.modules[name] = None
import asyncio
import numpy as np
from marie_tpu_torch.clients import GRPCClient
from marie_tpu_torch.executor import TextExtractionExecutorMock
from marie_tpu_torch.orchestrate.flow import Flow
from marie_tpu_torch.serve.runtimes.servers import GRPCServer
from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
from marie_tpu_torch.types import Document

async def main():
    server = GRPCServer(WorkerRequestHandler(uses=TextExtractionExecutorMock, name="mock"))
    await server.setup_server()
    client = GRPCClient(port=server.port, wire_mode="docs")
    page = np.full((32, 32), 255, np.uint8)
    resp = await client.apost("/document/extract", [Document(tensor=page)],
                              return_responses=True)
    health = await client.ahealth()
    await client.aclose()
    await server.shutdown()
    return resp, health

resp, health = asyncio.run(main())
print(resp.status.code, resp.wire_mode, resp.parameters["__results__"]["mock"]["status"], health,
      sorted(Flow().add(name="a").build()))
"""


def test_grpc_plane_serves_with_its_absent_packages_blocked():
    """The gRPC server and client, the flow and the wire codec import with
    JAX, grpc, protobuf, aiohttp, PyYAML (and the rest) blocked, and a
    request round-trips over gRPC in the DocListProto wire mode."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", f"BLOCKED = {BLOCKED!r}\n" + _GRPC_SERVING],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["0", "docs", "succeeded", "1", "['a',", "'start-gateway']"]


_TRAINERS = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint", "PIL", "cv2",
             "marie_tpu"):
    sys.modules[name] = None
import numpy as np
import marie_tpu_torch.train as train
from marie_tpu_torch.models.reading_order import ReadingOrderConfig
from marie_tpu_torch.ops.kernels.flash_attention import flash_attention_backward
from marie_tpu_torch.registry.convert import init_flax_defaults, to_flax
from marie_tpu_torch.train.loop import init_module
from marie_tpu_torch.train.optim import AdamW, warmup_cosine_decay_schedule
from marie_tpu_torch.train.reading_order import make_batch, pairwise_rank_loss
import torch
cfg = ReadingOrderConfig.tiny()
model = init_module(cfg, None, 0, device="cpu")
boxes, ranks, n = (torch.from_numpy(a) for a in make_batch(np.random.default_rng(0), 2, 256))
loss, acc = pairwise_rank_loss(model(boxes, n), ranks, n)
loss.backward()
print(len(to_flax(model)["params"]), sorted(train.__all__)[0])
from marie_tpu_torch.models.configs import CraftConfig, TrOCRConfig
ds = train.SyntheticWordDataset(TrOCRConfig.tiny(), seed=0, bold_p=1.0, shear_p=1.0,
                                rotate_deg=2, dither_p=1.0, text_mode="open")
images, tokens, texts = ds.sample(4)
page, targets = train.render_page_with_targets(np.random.default_rng(0), out_stride=4)
print(images.shape, tokens.shape[0], page.shape, targets.shape, int(targets.max()))
from marie_tpu_torch.train import (evaluate_boundary, render_page_tfn, train_boundary_device,
                                   train_dit_device, train_textfusenet_device)
tfn = render_page_tfn(np.random.default_rng(0))
print(train_boundary_device.__name__, train_dit_device.__name__,
      train_textfusenet_device.__name__, tfn[0].shape, tfn[1].shape, int(tfn[3].sum()) > 0)
from marie_tpu_torch.models.configs import Pix2PixConfig
from marie_tpu_torch.train.overlay import OverlayGan, init_overlay
clean, dirty, mask = train.render_overlay_pair(np.random.default_rng(0), (128, 160))
gen, disc = init_overlay(Pix2PixConfig.tiny(), 0, device="cpu")
x = torch.from_numpy(dirty[None]).float() / 127.5 - 1
y = torch.from_numpy(clean[None]).float() / 127.5 - 1
d_loss, g_loss, l1 = OverlayGan(gen, disc).step(x, y)
print(train.train_overlay_device.__name__, dirty.shape, int(mask.max()),
      bool((clean != dirty).any()), bool(torch.isfinite(g_loss)))
assert not any(m.split(".")[0] == "marie_tpu" for m in sys.modules if sys.modules[m] is not None)
"""


def test_trainers_import_with_jax_and_optax_blocked():
    """The trainers, the optimiser and K2's gradient import and step (on
    the CPU) with JAX, flax, optax, orbax, PIL, cv2 and the JAX package
    blocked, the OCR trainers' renderers draw a batch from the glyph
    atlas; the trainers ported last import, and the overlay trainer renders
    a pair and takes a GAN step."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _TRAINERS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].split() == ["5", "SyntheticWordDataset"]  # embed, 2 layers, ln_f, head
    assert lines[1] == "(4, 32, 64, 3) 4 (512, 384, 3) (128, 96, 2) 255"
    assert lines[2] == ("train_boundary_device train_dit_device train_textfusenet_device "
                        "(512, 384, 3) (256, 192, 4) True")
    assert lines[3] == "train_overlay_device (128, 160, 3) 255 True True"
    from marie_tpu_torch import train
    from marie_tpu_torch.train import boundary, dit, overlay, textfusenet

    assert train.train_boundary_device is boundary.train_boundary_device
    assert train.evaluate_boundary is boundary.evaluate_boundary
    assert train.train_dit_device is dit.train_dit_device
    assert train.train_textfusenet_device is textfusenet.train_textfusenet_device
    assert train.render_page_tfn is textfusenet.render_page_tfn
    assert train.train_overlay_device is overlay.train_overlay_device
    assert train.evaluate_overlay is overlay.evaluate_overlay
    assert train.render_overlay_pair is overlay.render_overlay_pair


def test_trainers_default_to_the_card():
    """Every trainer runs on the card unless the caller asks for the CPU."""
    import inspect

    from marie_tpu_torch.preprocess import ops
    from marie_tpu_torch.train import (
        boundary,
        craft,
        crnn,
        dit,
        layout,
        overlay,
        reading_order,
        recognizer,
        textfusenet,
    )

    for fn in (layout.train_layout_splitter, layout.train_layout_classifier,
               layout.train_layout_indexer, reading_order.train_reading_order,
               reading_order.train_reading_order_device, recognizer.train_recognizer,
               recognizer.train_recognizer_device, crnn.train_crnn_device,
               craft.train_craft_device, boundary.train_boundary_device, dit.train_dit_device,
               textfusenet.train_textfusenet_device, overlay.train_overlay_device,
               overlay.init_overlay, ops.crop_resize, ops.resize_page,
               ops.prepare_page):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


_SERVER_SHELL = r"""
import sys
for name in BLOCKED + ("psutil", "prometheus_client", "marie_tpu"):
    sys.modules[name] = None
import asyncio, inspect
from marie_tpu_torch import cli, jaml, parsers, schemas, server
from marie_tpu_torch.api import payload
from marie_tpu_torch.jaml import JAML, parser
from marie_tpu_torch.job import JobManager
from marie_tpu_torch.job.gateway_job_distributor import GatewayJobDistributor
from marie_tpu_torch.messaging import Toast
from marie_tpu_torch.messaging.native_handler import NativeToastHandler
from marie_tpu_torch.messaging.sqlite_handler import SqliteToastHandler
from marie_tpu_torch.orchestrate.export import to_docker_compose_yaml, to_kubernetes_yaml
from marie_tpu_torch.orchestrate.flow import Flow
from marie_tpu_torch.scheduler import SqlJobScheduler, WorkInfo
from marie_tpu_torch.storage.kv import InMemoryKV
from marie_tpu_torch.utils import kernel_cache, program_zoo
flow = Flow.load_config("config/service/marie.yml")
k8s = parser.load_all(to_kubernetes_yaml(flow))

async def jobs():
    s = SqlJobScheduler(":memory:")
    job_id = await s.submit_job(WorkInfo(name="q"))
    m = JobManager(InMemoryKV())
    j = await m.submit_job(entrypoint="/x")
    await asyncio.sleep(0.1)
    return s.fetch_next("q").id == job_id, (await m.get_job_status(j)).value

print(len(k8s), *asyncio.run(jobs()), payload.sniff_file_type(b"\x89PNG\r\n\x1a\n"),
      inspect.signature(server.run_server).parameters["device"].default,
      parsers.build_parser().parse_args(["server", "--start"]).device)
"""


def test_server_shell_imports_with_its_absent_packages_blocked():
    """JAML, the server shell, the CLI and parsers, jobs, the scheduler,
    Toast, the payload parser, the kernel cache and the warm-up import and
    run (on the CPU) with JAX, the JAX package, PyYAML, aiohttp, pydantic
    and PIL (and the rest) blocked; ``run_server`` and the CLI's server
    default to the card."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", f"BLOCKED = {BLOCKED!r}\n" + _SERVER_SHELL],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["6", "True", "succeeded", "png", "cuda", "cuda"]


_STATEFUL_AND_HUB = r"""
import sys, tempfile, time
for name in BLOCKED:
    sys.modules[name] = None
from marie_tpu_torch import hub, hub_docker
from marie_tpu_torch.serve.consensus import RaftNode, library_path
from marie_tpu_torch.serve.consensus.stateful import StatefulReplicatedHandler
from marie_tpu_torch.server import ctl, watch
from marie_tpu_torch.helper import random_port
node = RaftNode("solo", f"127.0.0.1:{random_port()}").start()
deadline = time.time() + 10
while not node.is_leader and time.time() < deadline:
    time.sleep(0.05)
index = node.submit(b"x\0y")
while node.applied != [b"x\0y"] and time.time() < deadline:
    time.sleep(0.05)
node.shutdown()
with tempfile.TemporaryDirectory() as d:
    import os
    os.makedirs(f"{d}/pkg")
    open(f"{d}/pkg/config.yml", "w").write("jtype: BaseExecutor\n")
    h = hub.ExecutorHub(hub_dir=f"{d}/hub", install_dir=f"{d}/inst")
    h.push(f"{d}/pkg", "e", "1.0.0", metadata={"note": "a: b"})
    manifest = h.manifest("e")
    installed = h.resolve("hub://e")
print(index, library_path().parent.name, manifest["note"], os.path.basename(installed),
      len(ctl.render_help(40, 12)))
"""


def test_stateful_and_hub_import_with_their_absent_packages_blocked():
    """The RAFT bindings, the stateful handler, the hub and its OCI client,
    and the consoles import and run with JAX, the JAX package, PyYAML,
    aiohttp, PIL (and the rest) blocked: a node of the port's core commits
    an entry, and a bundle's manifest goes through the port's YAML."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", f"BLOCKED = {BLOCKED!r}\n" + _STATEFUL_AND_HUB],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["1", "_build", "a:", "b", "e", "12"]
