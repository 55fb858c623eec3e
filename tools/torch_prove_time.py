#!/usr/bin/env python3
"""Wall time of the 2^20 SNARK's encode and prove in checkouts of the port,
each in a fresh process, for comparing commits on one card.

    python3 tools/torch_prove_time.py build/parent . . build/parent

Runs the trees in the order given (parent, change, change, parent pairs
the two in turns). Each run builds the kernels if needed, makes
``synthetic(20)`` from its seed, then times ``SNARK.encode`` and
``SNARK.prove`` with the host clock, each ending in
``torch.cuda.synchronize()``, with no timing instrumentation on. Prints
one JSON line per run, then the card's name and power limit. Needs one
CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys

CHILD = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from spartan_tpu_torch.io.keyless_bench import synthetic
from spartan_tpu_torch.ops import kernels as K
from spartan_tpu_torch.snark import SNARK, SNARKGens
from spartan_tpu_torch.utils.random_tape import RandomTape
from spartan_tpu_torch.utils.transcript import Transcript
K.build_all()
inst, vars_, inputs, nnz = synthetic(20)
n = inst.inst.num_cons
gens = SNARKGens(n, n, 1, nnz)
torch.cuda.synchronize()
t = time.perf_counter()
comm, decomm = SNARK.encode(inst, gens)
torch.cuda.synchronize()
encode_s = time.perf_counter() - t
t = time.perf_counter()
proof = SNARK.prove(inst, comm, decomm, vars_, inputs, gens, Transcript(b"chip_smoke"),
                    RandomTape(b"chip_smoke", seed=bytes([5]) * 32))
torch.cuda.synchronize()
prove_s = time.perf_counter() - t
print(json.dumps({"tree": sys.argv[2], "encode_s": encode_s, "prove_s": prove_s}), flush=True)
'''


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in sys.argv[1:]:
        rc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(tree), tree],
                            cwd=os.path.abspath(tree)).returncode
        if rc:
            return rc
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
