#!/usr/bin/env python3
"""Time the port's CUDA kernels at the main path's shapes, cold and warm,
for this checkout or another one, so that two versions can be compared
in turns on one card:

    git archive <commit> | tar -x -C .chip_tree/parent   # a git-ignored dir
    python3 scripts/kernel_times.py --tree .chip_tree/parent
    python3 scripts/kernel_times.py
    python3 scripts/kernel_times.py
    python3 scripts/kernel_times.py --tree .chip_tree/parent

Builds the kernels of ``--tree``'s ``marie_tpu_torch`` (default: this
checkout) and runs this checkout's ``chip_smoke.py`` phases ``k1`` (at
256 crops, the 128-crop overflow chunk and the 2,560-crop serving
batch) and ``k2`` against that package: each kernel is held against its plain
version and timed, cold and warm, beside its plain version and SDPA.
Prints their JSON lines tagged with the tree, after one line with the
card, the build (with ptxas's register counts where this process built
the libraries) and the tensor-core (HMMA) instructions in each built
library by opcode (where ``cuobjdump`` is installed), and before one line of
floors timed the same way: a one-element ``add_`` (the launch floor of a
back-to-back run) and a ``fill_`` of K1's 15.7 MB output (the store
floor).  With ``--mma-rate`` the floors also hold the card's
``mma.sync`` TF32 rate (``scripts/mma_rate.cu``, built then: the ceiling
of K2's float32 path, which spends three MMAs per product).  With
``--train`` it also runs ``chip_smoke.py``'s gradient rows
(``_train_kernel_rows``: K2's backward at the six ``TRAIN_K2_CASES``
shapes, held against its plain version, cold and warm, with K2's and
SDPA's forward + backward beside it), without the trainers; so

    python3 scripts/kernel_times.py --train --tree .chip_tree/parent

times an earlier commit's gradient kernel through the same API.  Needs a
CUDA device.
"""

import argparse
import collections
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sass_hmma(path: str):
    """{opcode: count} of the tensor-core (HMMA) instructions in a shared
    library's SASS (``HMMA.16816.F32.BF16`` for bf16, ``HMMA.1688.F32.TF32``
    for TF32), or None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    return dict(collections.Counter(
        m.group(0) for m in re.finditer(r"\bHMMA(\.\w+)*", sass)))


def mma_tf32_tflops(build_dir: str) -> float:
    """TFLOP/s of ``scripts/mma_rate.cu``'s loop of mma.sync.m16n8k8 TF32,
    8 blocks of 128 threads an SM, 4,096 steps (events around one launch
    after a warm-up)."""
    import ctypes

    import torch

    from marie_tpu_torch.ops.kernels import _build

    lib_path = os.path.join(build_dir, "libmma_rate.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(ROOT, "scripts", "mma_rate.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.mt_mma_tf32_loop.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mt_mma_tf32_flops.argtypes = [ctypes.c_int] * 3
    lib.mt_mma_tf32_flops.restype = ctypes.c_double
    blocks, threads, iters = 8 * torch.cuda.get_device_properties(0).multi_processor_count, 128, 4096
    out = torch.empty(blocks * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lib.mt_mma_tf32_loop(out.data_ptr(), blocks, threads, 64, stream)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    code = lib.mt_mma_tf32_loop(out.data_ptr(), blocks, threads, iters, stream)
    end.record()
    end.synchronize()
    if code != 0:
        raise RuntimeError(f"mma_rate: CUDA error {code}")
    return lib.mt_mma_tf32_flops(blocks, threads, iters) / start.elapsed_time(end) / 1e9


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose marie_tpu_torch is timed (default: this one)")
    ap.add_argument("--mma-rate", action="store_true",
                    help="also build and time scripts/mma_rate.cu")
    ap.add_argument("--train", action="store_true",
                    help="also time K2's gradient at the trainers' shapes")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)  # the package under test
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from marie_tpu_torch.ops.kernels import _build
    from marie_tpu_torch.utils.device import card_name_and_power_limit, set_parity_precision

    if not os.path.abspath(_build.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"marie_tpu_torch came from {_build.__file__}, not {tree}")
    label = os.path.relpath(tree, ROOT)
    chip_smoke.emit = lambda obj: print(json.dumps({"tree": label, **obj}), flush=True)
    set_parity_precision()
    built = _build.build_all()
    chip_smoke.emit({"phase": "device", "card": card_name_and_power_limit(),
                     "built_s": built, "ptxas": getattr(_build, "PTXAS", None),
                     "hmma": {n: sass_hmma(str(_build._lib_path(n))) for n in _build.sources()}})
    chip_smoke.phase_k1()
    chip_smoke.phase_k1(1, 128, "overflow_chunk")
    chip_smoke.phase_k1(chip_smoke.SLICE_PAGES, chip_smoke.SLICE_PAGES * 160, "serving")
    chip_smoke.phase_k2()
    if args.train:
        chip_smoke._train_kernel_rows()
    tiny = [torch.zeros(1, device="cuda") for _ in range(4)]
    crops = (256, 48, 320)  # K1's output at the slice's shapes, float32
    floors = {
        "phase": "floors",
        "launch_ms": chip_smoke.timed(lambda i: tiny[i].add_(1.0), 4),
        "store_k1_output_ms": chip_smoke.timed(
            lambda i: torch.empty(crops, device="cuda").fill_(1.0), 7)}
    if args.mma_rate:
        floors["mma_tf32_tflops"] = mma_tf32_tflops(str(_build.BUILD_DIR))
    chip_smoke.emit(floors)
    return 0


if __name__ == "__main__":
    sys.exit(main())
