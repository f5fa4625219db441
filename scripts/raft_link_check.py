"""The RAFT core beside CUDA torch, with the plain build flags and with
the port's (``serve/consensus``'s ``CXX_FLAGS``: its own libstdc++ and
libgcc, hidden, and ``-Bsymbolic``).  Builds ``csrc/raft.cpp`` both ways,
then, in ``--runs`` child processes for each of two ways of initialising
CUDA through torch (:data:`INITS`: a tensor alone, or a cuBLAS product and
a cuDNN convolution as a worker's engine runs), runs a three-node cluster
(an election, four 2.1 MB entries, each node's configuration).  Prints
one JSON line: {"flags | init": {"runs", "crashed", "rcs"}}; a child
killed by SIGSEGV has rc -11.  Needs the card::

    python3 scripts/raft_link_check.py [--runs 4]
"""

import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: how each child initialises CUDA before it loads the library
INITS = {
    "ones": 'torch.ones(10, device="cuda").sum().item()',
    "blas_dnn": 'x = torch.randn(64, 64, device="cuda"); (x @ x).sum().item(); '
                'torch.nn.functional.conv2d(torch.randn(1, 3, 32, 32, device="cuda"), '
                'torch.randn(8, 3, 3, 3, device="cuda")).sum().item()',
}

CHILD = r"""
import json, os, sys, time
sys.path.insert(0, {repo!r})
import torch
{init}
from pathlib import Path
from marie_tpu_torch.helper import random_port
from marie_tpu_torch.serve import consensus
consensus.library_path = lambda: Path({lib!r})
consensus.build_library = lambda: None
addrs = [f"127.0.0.1:{{random_port()}}" for _ in range(3)]
nodes = [consensus.RaftNode(f"n{{i}}", addrs[i]) for i in range(3)]
for i, n in enumerate(nodes):
    for j, a in enumerate(addrs):
        if i != j:
            n.add_voter(f"n{{j}}", a)
for n in nodes:
    n.start()
t = time.time()
while not any(n.is_leader for n in nodes) and time.time() - t < 10:
    time.sleep(0.05)
leader = next(n for n in nodes if n.is_leader)
for _ in range(4):
    leader.submit(os.urandom(2_100_000))
while not all(len(n.applied) == 4 for n in nodes) and time.time() - t < 30:
    time.sleep(0.05)
leaders = [n.get_configuration()["leader"] for n in nodes]
print(json.dumps({{"applied": [len(n.applied) for n in nodes], "leaders": leaders}}))
for n in nodes:
    n.shutdown()
"""


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", type=int, default=4, help="children per build and init")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import torch

    from marie_tpu_torch.serve import consensus

    if not torch.cuda.is_available():
        print("raft_link_check: no CUDA device", file=sys.stderr)
        return 2
    plain = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, flags in (("plain", plain), ("port", consensus.CXX_FLAGS)):
            lib = os.path.join(tmp, f"lib{label}.so")
            subprocess.run(["g++", *flags, "-o", lib, str(consensus.SOURCE)], check=True)
            for init_name, init in INITS.items():
                rcs = []
                for _ in range(args.runs):
                    r = subprocess.run(
                        [sys.executable, "-c", CHILD.format(repo=REPO, lib=lib, init=init)],
                        capture_output=True, text=True, timeout=120)
                    ok = r.returncode == 0 and json.loads(
                        r.stdout.strip().splitlines()[-1])["applied"] == [4, 4, 4]
                    rcs.append(r.returncode if r.returncode or ok else "not applied")
                out[f"{' '.join(flags)} | {init_name}"] = {
                    "runs": args.runs, "crashed": sum(rc == -11 for rc in rcs), "rcs": rcs}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
