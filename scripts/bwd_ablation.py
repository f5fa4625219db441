#!/usr/bin/env python3
"""Where K2's gradient kernels spend their time: build variants of
``marie_tpu_torch/csrc/flash_attention_bwd.cu`` with one part of the work
taken out, and time each kernel (``dq_kernel``, ``dkdv_kernel``) of every
variant beside the real one at the six ``chip_smoke.py`` ``TRAIN_K2_CASES``
shapes:

    python3 scripts/bwd_ablation.py

The variants compute wrong gradients on purpose; only their times mean
anything.  ``one_mma``: one TF32 MMA a product instead of three;
``no_split``: the TF32 split does no arithmetic; ``fast_exp``: ``__expf``
in place of ``expf``; ``no_wait``: the kernels do not wait for their
``cp.async`` copies.  Per-kernel device times come from torch.profiler
over one pass of the inputs (rotated over copies that hold >100 MB, as
``chip_smoke.py``'s cold timing).  Prints the card, ptxas's lines of each
build, then one JSON line a shape.  Needs a CUDA device; the variants are
built under the package's ``_build/ablation``.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "marie_tpu_torch", "csrc", "flash_attention_bwd.cu")

_SPLIT = """  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;"""
_FIRST = """    if constexpr (TRANS) mma_tf32(c[n], ah, bl[n][0], bl[n][1]);
    else mma_tf32(c[n], al, bh[n][0], bh[n][1]);"""
_SECOND = """    if constexpr (TRANS) mma_tf32(c[n], al, bh[n][0], bh[n][1]);
    else mma_tf32(c[n], ah, bl[n][0], bl[n][1]);"""
#: {variant: [(text of the source, its replacement), ...]}
VARIANTS = {
    "one_mma": [(_FIRST, "    (void)0;"), (_SECOND, "    (void)0;")],
    "no_split": [(_SPLIT, "  hi = __float_as_uint(x);\n  lo = hi;")],
    "fast_exp": [("expf(fmaf(", "__expf(fmaf(")],
    "no_wait": [('asm volatile("cp.async.wait_group %0;\\n" ::"n"(N) : "memory");', "(void)0;")],
}


def build_variants(build_dir, nvcc, flags):
    """{variant: loaded library}, all built in parallel; prints ptxas's lines."""
    src = open(SOURCE).read()
    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(build_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen([nvcc, *flags, "-o", cu[:-3] + ".so", cu],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(name, json.dumps([ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                                if "Used" in ln or "spill" in ln]), flush=True)
        libs[name] = ctypes.CDLL(os.path.join(build_dir, f"{name}.so"))
    return libs


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from marie_tpu_torch.ops.kernels import _build
    from marie_tpu_torch.ops.kernels import flash_attention as k2
    from marie_tpu_torch.utils.device import card_name_and_power_limit, set_parity_precision

    set_parity_precision()
    print(card_name_and_power_limit(), flush=True)
    _build.build_all(["flash_attention", "flash_attention_bwd"])
    argtypes = k2._bwd_lib().mt_flash_attention_bwd.argtypes
    libs = build_variants(str(_build.BUILD_DIR / "ablation"), _build._nvcc(), _build.NVCC_FLAGS)
    for lib in libs.values():
        lib.mt_flash_attention_bwd.argtypes = argtypes
        lib.mt_flash_attention_bwd.restype = ctypes.c_int

    def variant_call(lib, q, k, v, lse, do, kv_len, causal):
        b, h, sq, d = q.shape
        skv = k.shape[2]
        stats = torch.empty((2, b, h, sq), device="cuda")
        dq, dk, dv = (torch.empty((b, s, h, d), device="cuda").transpose(1, 2)
                      for s in (sq, skv, skv))
        code = lib.mt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            kv_len.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            k2._strides(q, k, v, do, dq, dk, dv), b, h, sq, skv, d, d ** -0.5, int(causal),
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"bwd_ablation: CUDA error {code}")

    for i, (name, (b, h, sq, skv, d), causal, source) in enumerate(cs.TRAIN_K2_CASES):
        kv_len = cs._train_kv_len(source, b, skv)
        copies = cs.n_copies(2 * 4 * b * h * (2 * sq + 2 * skv) * d)

        def make(c):
            q, k, v = cs._attn_inputs(b, h, sq, skv, d, torch.float32,
                                      cs.SEED + 200 + i + 100 * c, True)
            do = cs._attn_inputs(b, h, sq, sq, d, torch.float32,
                                 cs.SEED + 300 + i + 100 * c, True)[0]
            return q, k, v, k2.flash_attention_lse(q, k, v, kv_len, causal)[1], do

        ins = [make(c) for c in range(copies)]
        runs = {"kernel": lambda c: k2.flash_attention_backward(*ins[c], kv_len, causal)}
        for vname, lib in libs.items():
            runs[vname] = (lambda lib: lambda c: variant_call(lib, *ins[c], kv_len, causal))(lib)
        row = {"case": name, "shape": [b, h, sq, skv, d]}
        for vname, fn in runs.items():
            for c in range(copies):  # warm-up
                fn(c)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for c in range(copies):
                    fn(c)
                torch.cuda.synchronize()
            row[vname] = {kname: evt.self_device_time_total / evt.count
                          for evt in prof.key_averages()
                          for kname in ("dq_kernel", "dkdv_kernel") if kname in evt.key}
        print(json.dumps(row), flush=True)
        del ins
    return 0


if __name__ == "__main__":
    sys.exit(main())
