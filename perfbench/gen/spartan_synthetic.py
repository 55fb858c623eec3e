"""Spartan's own synthetic R1CS instance (microsoft/Spartan,
``R1CSInstance::produce_synthetic_r1cs``), made from a seed.

z = (vars, 1, inputs) is drawn at random; row i of A and B is one unit
entry on columns i and i + 2 (mod |z|), and row i of C one entry on column
i + 3 whose value makes the row hold: A z * B z / z[i + 3], or on the
constant column with value A z * B z where z[i + 3] is 0. Nothing is
padded: Spartan's instance needs num_cons and num_vars to be powers of
two.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np

FR = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001


def _rng(seed: int, salt: bytes) -> random.Random:
    return random.Random(hashlib.sha256(salt + str(seed).encode()).digest())


def build(config: dict, seed: int, cache_dir: str, witnesses_n: int = 1,
          device="cpu") -> dict:
    """The instance and its satisfying assignment: ``matrices`` (A, B, C as
    (rows, cols, vals) in Spartan's column layout) and ``witnesses``, one
    (inputs, vars): the matrices are made from z, so the instance has no
    other witness to draw."""
    del cache_dir, device  # nothing to cache or to compute on the device
    if witnesses_n != 1:
        raise ValueError("Spartan's synthetic instance has one witness")
    n_cons, n_vars, n_in = config["num_cons"], config["num_vars"], config["num_inputs"]
    rng = _rng(seed, b"spartan-synthetic")
    z = [rng.getrandbits(256) % FR for _ in range(n_vars)] + [1] + \
        [rng.getrandbits(256) % FR for _ in range(n_in)]
    size_z = len(z)
    i = np.arange(n_cons, dtype=np.int64)
    a_idx, b_idx, c_idx = i % size_z, (i + 2) % size_z, (i + 3) % size_z
    ab = [z[a] * z[b] % FR for a, b in zip(a_idx.tolist(), b_idx.tolist())]
    zc = [z[c] for c in c_idx.tolist()]
    nonzero = [k for k, v in enumerate(zc) if v]
    inv = _batch_inv([zc[k] for k in nonzero])
    c_vals, c_cols = list(ab), c_idx.copy()
    for k, iv in zip(nonzero, inv):
        c_vals[k] = ab[k] * iv % FR
    zero = np.array([v == 0 for v in zc], dtype=bool)
    c_cols[zero] = n_vars
    ones = [1] * n_cons
    return {"num_cons": n_cons, "num_vars": n_vars, "num_inputs": n_in,
            "matrices": ((i, a_idx, ones), (i, b_idx, list(ones)), (i, c_cols, c_vals)),
            "witnesses": [(z[n_vars + 1:], z[:n_vars])]}


def _batch_inv(vals: list[int]) -> list[int]:
    prefix = [1] * (len(vals) + 1)
    for k, v in enumerate(vals):
        prefix[k + 1] = prefix[k] * v % FR
    acc = pow(prefix[-1], -1, FR) if vals else 1
    out = [0] * len(vals)
    for k in range(len(vals) - 1, -1, -1):
        out[k] = acc * prefix[k] % FR
        acc = acc * vals[k] % FR
    return out
