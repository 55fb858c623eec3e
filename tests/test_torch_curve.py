"""spartan_tpu_torch G1 ops (kernel H2's plain version on the CPU) against the
host curve and the JAX package's curve_jax, on the same inputs.

Points come from numpy-seeded scalars times the generator; projective
representations are randomized so the complete formulas see Z != 1. The
JAX package is imported only inside the test that uses it.
"""

import numpy as np
import pytest
import torch

from spartan_tpu_torch import device as DEV
from spartan_tpu_torch import interop
from spartan_tpu_torch.ops import curve as CU
from spartan_tpu_torch.ops import curve_host as CH
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import fields_host as fh

RNG = np.random.default_rng(7)
SCALARS = [int(s) for s in RNG.integers(1, 1 << 62, size=12)]
PTS = [CH.scalar_mul(s, CH.GEN) for s in SCALARS]


def proj(points, seed):
    """Projective CPU tensors of host points, scaled by random Z."""
    with DEV.use("cpu"):
        p = CU.encode_points(points)
        rng = np.random.default_rng(seed)
        zs = [int(v) % (fh.FQ_MOD - 1) + 1 for v in rng.integers(1, 1 << 62, size=len(points))]
        z = F.encode_fq(zs)
    return tuple(F.fq.mul(c, z) for c in p)


def test_encode_decode_roundtrip():
    with DEV.use("cpu"):
        withinf = PTS[:3] + [None] + PTS[3:5]
        assert CU.decode_points(CU.encode_points(withinf)) == withinf
        assert CU.decode_points(proj(withinf, 1)) == withinf


@pytest.mark.parametrize("case", ["generic", "identity", "double", "inverse"])
def test_padd_vs_host(case):
    A = list(PTS)
    B = {"generic": PTS[::-1], "identity": [None] * 6 + PTS[6:],
         "double": PTS, "inverse": [CH.neg(p) for p in PTS]}[case]
    if case == "identity":
        A = PTS[:3] + [None] * 3 + PTS[6:]
    got = CU.decode_points(CU.padd(proj(A, 2), proj(B, 3)))
    assert got == [CH.add(a, b) for a, b in zip(A, B)]


def test_pdbl_vs_host():
    pts = PTS[:5] + [None]
    assert CU.decode_points(CU.pdbl(proj(pts, 4))) == [CH.add(p, p) for p in pts]


def test_padd_mixed_matches_padd():
    """Alg 8 with an affine point equals Alg 7 with Z2 = 1, bit for bit."""
    P = proj(PTS[:6] + [None], 5)
    with DEV.use("cpu"):
        x, y, _ = CU.encode_points_affine(PTS[5:12])
    full = CU.padd(P, (x, y, F.fq.one((7,), "cpu")))
    mixed = CU.padd_mixed_plain(P, x, y)
    assert all(torch.equal(a, b) for a, b in zip(full, mixed))


def test_padd_pdbl_match_curve_jax():
    """Same projective limbs as the JAX package's complete formulas."""
    import jax.numpy as jnp

    from spartan_tpu.ops import curve_jax as CJ

    P, Q = proj(PTS, 6), proj(PTS[::-1][:6] + [None] * 6, 7)
    to_j = lambda pt: tuple(jnp.asarray(interop.from_port(c)) for c in pt)
    jadd = CJ.padd(to_j(P), to_j(Q))
    for mine, theirs in zip(CU.padd(P, Q), jadd):
        assert np.array_equal(interop.from_port(mine), np.asarray(theirs))


def test_scalar_mul_vs_host():
    ks = [int(v) for v in RNG.integers(0, 1 << 62, size=4)] + [0, fh.FR_MOD - 1]
    pts = PTS[:6]
    sc = F.encode_canonical(ks, "cpu")
    got = CU.decode_points(CU.scalar_mul(sc, proj(pts, 8), num_bits=254))
    assert got == [CH.scalar_mul(k, p) for k, p in zip(ks, pts)]


def test_batch_normalize():
    pts = PTS[:4] + [None] + PTS[4:6]
    x, y, inf = CU.batch_normalize(proj(pts, 9))
    xs, ys = F.decode_fq(x), F.decode_fq(y)
    assert inf.tolist() == [p is None for p in pts]
    assert [None if i else (a, b) for a, b, i in zip(xs, ys, inf.tolist())] == pts
    assert ys[4] == 1 and xs[4] == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_h2_kernel_matches_plain(cuda):
    P = tuple(c.to(cuda) for c in proj(PTS[:6] + [None] * 2 + PTS[:4], 10))
    Q = tuple(c.to(cuda) for c in proj([None] * 2 + PTS[:6] + PTS[:4], 11))
    for k, p in zip(CU.padd(P, Q), CU.padd_plain(P, Q)):
        assert torch.equal(k, p)
    for k, p in zip(CU.pdbl(P), CU.pdbl_plain(P)):
        assert torch.equal(k, p)
