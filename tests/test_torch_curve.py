"""spartan_tpu_torch G1 ops (kernel H2's plain versions on the CPU) against the
host curve and the JAX package's curve_jax, on the same inputs.

Points come from numpy-seeded scalars times the generator; projective
representations are randomized so the complete formulas see Z != 1. H2's
two ladders (Horner, double-and-add) are held to the loops of the plain
formulas they replace bit for bit on (X:Y:Z). The JAX package is imported
only inside the tests that use it.
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

from torch_threads import _one_thread  # noqa: F401

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


def windows(W, seed):
    """[W, 8] window sums: identities, equal points, a point and its
    negative, each row with its own projective scale."""
    rows = [PTS[(seed + w) % 12: (seed + w) % 12 + 8] for w in range(W)]
    rows = [r + PTS[:8 - len(r)] for r in rows]
    rows[0][1] = rows[1 % W][1] = None          # identities, first window too
    rows[W - 1][2] = None
    for w in range(W):
        rows[w][3] = PTS[4]                      # the same point in every window
    rows[W - 1][5] = CH.neg(rows[0][5])
    cols = [proj(r, seed * 10 + w) for w, r in enumerate(rows)]
    return tuple(torch.stack([c[k] for c in cols]) for k in range(3)), rows


def horner_loop(win, c):
    """The loop of plain formulas that H2's Horner entry replaces."""
    acc = tuple(a[0] for a in win)
    for w in range(1, win[0].shape[0]):
        for _ in range(c):
            acc = CU.pdbl_plain(acc)
        acc = CU.padd_plain(acc, tuple(a[w] for a in win))
    return acc


def host_horner(rows, c):
    out = []
    for i in range(len(rows[0])):
        acc = None
        for r in rows:
            acc = CH.add(CH.scalar_mul(1 << c, acc) if acc else None, r[i])
        out.append(acc)
    return out


@pytest.mark.parametrize("c,W", [(3, 5), (7, 4)])
def test_horner_plain(c, W):
    """The Horner entry on CPU tensors == the loop it replaces (bit for
    bit) == sum_w 2^(c (W-1-w)) S_w on the host curve."""
    win, rows = windows(W, c)
    got = CU.horner(win, c)
    assert all(torch.equal(a, b) for a, b in zip(got, horner_loop(win, c)))
    assert CU.decode_points(got) == host_horner(rows, c)


def test_horner_matches_curve_jax():
    """The same projective limbs as the JAX package's padd/pdbl ladder."""
    import jax.numpy as jnp

    from spartan_tpu.ops import curve_jax as CJ

    c, W = 3, 3
    win, _ = windows(W, 1)
    to_j = lambda pt: tuple(jnp.asarray(interop.from_port(a)) for a in pt)
    acc = to_j(tuple(a[0] for a in win))
    for w in range(1, W):
        for _ in range(c):
            acc = CJ.pdbl(acc)
        acc = CJ.padd(acc, to_j(tuple(a[w] for a in win)))
    for mine, theirs in zip(CU.horner(win, c), acc):
        assert np.array_equal(interop.from_port(mine), np.asarray(theirs))


def scalar_mul_loop(sc, p, num_bits):
    """The loop of plain formulas that H2's double-and-add entry replaces."""
    words = sc.to(torch.int64) & 0xFFFFFFFF
    acc = CU.identity(sc.shape[:-1], "cpu")
    for i in range(num_bits - 1, -1, -1):
        acc = CU.pdbl_plain(acc)
        added = CU.padd_plain(acc, p)
        take = ((words[..., i // 32] >> (i % 32)) & 1) == 1
        acc = CU.pselect(take, added, acc)
    return acc


def test_scalar_mul_plain_vs_loop():
    """40-bit scalars (0, 1, 2^40 - 1 among them) on identities and equal
    points: the double-and-add entry == its loop bit for bit, and k * P on
    the host curve."""
    ks = [0, 1, (1 << 40) - 1] + [int(v) for v in RNG.integers(1, 1 << 40, size=5)]
    pts = [PTS[0], None, PTS[0], PTS[1], PTS[1], None, PTS[2], PTS[3]]
    sc = F.encode_canonical(ks, "cpu")
    P = proj(pts, 12)
    got = CU.scalar_mul(sc, P, num_bits=40)
    assert all(torch.equal(a, b) for a, b in zip(got, scalar_mul_loop(sc, P, 40)))
    assert CU.decode_points(got) == [CH.scalar_mul(k, p) if p else None
                                     for k, p in zip(ks, pts)]


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
@pytest.mark.parametrize("c,W", [(3, 5), (10, 26)])
def test_h2_horner_matches_plain(cuda, c, W):
    win, _ = windows(min(W, 5), c)
    win = tuple(torch.cat([a] * -(-W // a.shape[0]))[:W].to(cuda) for a in win)
    got = CU.horner(win, c)
    for k, p in zip(got, CU.horner_plain(win, c)):
        assert torch.equal(k, p)


@pytest.mark.gpu
def test_h2_scalar_mul_matches_plain(cuda):
    ks = [0, 1, fh.FR_MOD - 1] + [int(v) for v in RNG.integers(1, 1 << 62, size=5)]
    sc = F.encode_canonical(ks, cuda)
    P = tuple(c.to(cuda) for c in proj([PTS[0], None, PTS[0]] + PTS[1:6], 13))
    for k, p in zip(CU.scalar_mul(sc, P), CU.scalar_mul_plain(sc, P)):
        assert torch.equal(k, p)


@pytest.mark.gpu
def test_h2_kernel_matches_plain(cuda):
    P = tuple(c.to(cuda) for c in proj(PTS[:6] + [None] * 2 + PTS[:4], 10))
    Q = tuple(c.to(cuda) for c in proj([None] * 2 + PTS[:6] + PTS[:4], 11))
    for k, p in zip(CU.padd(P, Q), CU.padd_plain(P, Q)):
        assert torch.equal(k, p)
    for k, p in zip(CU.pdbl(P), CU.pdbl_plain(P)):
        assert torch.equal(k, p)
