"""Synthetic R1CS instances for benchmarks and tests.

Counterpart of ``synthetic`` in ``spartan_tpu/io/keyless_bench.py``: the
same seeded generator, so both packages build the same instance from the
same arguments. The circom ingestion and the benchmark driver are not
ported yet.
"""

from __future__ import annotations

import random

from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.snark import Assignment, Instance


def synthetic(log2_cons: int, num_inputs: int = 1, nnz_per_row: int = 3, seed: int = 0):
    """Random satisfiable R1CS at 2^log2_cons constraints/variables."""
    from spartan_tpu_torch.core.r1cs import R1CSShape

    rng = random.Random(seed)
    n = 1 << log2_cons
    vars_ = [rng.randrange(FR_MOD) for _ in range(n)]
    inputs = [rng.randrange(FR_MOD) for _ in range(num_inputs)]
    z = vars_ + [1] + inputs
    A, B, C = [], [], []
    for i in range(n):
        az = bz = 0
        for _ in range(nnz_per_row):
            ca, cb = rng.randrange(len(z)), rng.randrange(len(z))
            va, vb = rng.randrange(1, FR_MOD), rng.randrange(1, FR_MOD)
            A.append((i, ca, va))
            B.append((i, cb, vb))
            az = (az + va * z[ca]) % FR_MOD
            bz = (bz + vb * z[cb]) % FR_MOD
        C.append((i, n, az * bz % FR_MOD))
    shape = R1CSShape(n, n, num_inputs, A, B, C)
    max_nnz = max(len(A), len(B), len(C))
    return Instance.from_shape(shape), Assignment(vars_), Assignment(inputs), max_nnz
