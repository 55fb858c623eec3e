"""spartan_tpu_torch MSM (kernels H3 + H4's plain versions on the CPU) against
the JAX package's bucket stage and MSM, and the native C host MSM.

Generators are numpy-seeded multiples of G; group elements are compared as
affine points, never as projective coordinates. The JAX package is
imported only inside the tests that use it.
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
from spartan_tpu_torch.ops import msm as M

RNG = np.random.default_rng(11)
BASE = [CH.scalar_mul(int(s), CH.GEN) for s in RNG.integers(1, 1 << 60, size=24)]


def points(n, inf=()):
    pts = [BASE[i % len(BASE)] for i in range(n)]
    for i in inf:
        pts[i] = None
    return pts


def scalars(n, seed, zeros=()):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    from spartan_tpu_torch.ops.limbs import limbs_to_ints

    xs = [v % fh.FR_MOD for v in limbs_to_ints(words)]
    for i in zeros:
        xs[i] = 0
    return xs


def affine(pts):
    with DEV.use("cpu"):
        return CU.encode_points_affine(pts)


def decode1(pt):
    return CU.decode_points(tuple(a.unsqueeze(0) for a in pt))[0]


@pytest.mark.parametrize("c,num_bits", [(4, 254), (7, 254), (13, 254), (16, 254), (8, 256)])
def test_window_digits(c, num_bits):
    xs = scalars(6, c, zeros=(0,)) + [fh.FR_MOD - 1]
    d = M.window_digits(F.encode_canonical(xs, "cpu"), c, num_bits)
    assert d.shape == (7, -(-num_bits // c)) and d.dtype == torch.int32
    for i, x in enumerate(xs):
        assert sum(int(v) << (c * w) for w, v in enumerate(d[i].tolist())) == x


def test_bucket_stage_matches_jax():
    """H3 + H4 window sums equal the JAX package's _bucket_windows."""
    import jax.numpy as jnp

    from spartan_tpu.ops import msm as MJ

    pts = points(20, inf=(3,))
    digits = RNG.integers(0, 16, size=(3, 20)).astype(np.uint32)
    aff = affine(pts)
    mine = CU.decode_points(M.bucket_windows(aff, torch.from_numpy(digits.astype(np.int32)), 4))
    jaff = tuple(jnp.asarray(interop.from_port(a)) for a in aff[:2]) + \
        (jnp.asarray(aff[2].numpy()),)
    from spartan_tpu.ops import curve_jax as CJ

    theirs = CJ.decode_points(MJ._bucket_windows(jaff, jnp.asarray(digits), 4))
    assert mine == theirs
    # and against the definition: sum_i digit_i * P_i per row
    for r in range(3):
        assert mine[r] == CH.msm([int(v) for v in digits[r]], pts)


@pytest.mark.parametrize("seglen", [1, 4, 16])
def test_weighted_segments(seglen, monkeypatch):
    """Any split of the buckets into segments gives sum_b b * B_b."""
    monkeypatch.setattr(M, "SEGLEN", seglen)
    c = 4
    nb = (1 << c) - 1
    bpts = [BASE[i % len(BASE)] if i % 5 else None for i in range(2 * nb)]
    with DEV.use("cpu"):
        buckets = tuple(a.reshape(2, nb, 8) for a in CU.encode_points(bpts))
    got = CU.decode_points(M.weighted_sums(buckets, c))
    for r in range(2):
        assert got[r] == CH.msm(list(range(1, nb + 1)), bpts[r * nb:(r + 1) * nb])


def test_infinity_points_get_digit_zero():
    pts = points(8, inf=(1, 5))
    digits = torch.full((2, 8), 3, dtype=torch.int32)
    px, py, order, lo, hi = M.bucket_inputs(affine(pts), digits, 2)
    # bucket 3 holds the six finite points of each row, bucket 0 (unread) the rest
    assert (hi - lo)[:, 2].tolist() == [6, 6]
    assert (hi - lo)[:, :2].sum().item() == 0


@pytest.mark.parametrize("n", [65, 100])
def test_msm_vs_native(n):
    """Bucket path (above the ladder cutoff): zeros, infinity, batched rows."""
    assert n > M.LADDER_N
    pts = points(n, inf=(7,))
    s1, s2 = scalars(n, n, zeros=(0, 5)), scalars(n, n + 1)
    sc = F.encode_canonical(s1 + s2, "cpu").reshape(2, n, 8)
    got = CU.decode_points(M.msm(affine(pts), sc))
    assert got == [CH.msm(s1, pts), CH.msm(s2, pts)]


def test_msm_stage_accumulators():
    """While collecting, each bucket-path stage is accumulated under the
    innermost running Timer; the result is the same as without."""
    from spartan_tpu_torch.utils.timer import Timer

    n = 65
    pts = points(n)
    xs = scalars(n, 4)
    sc = F.encode_canonical(xs, "cpu")
    Timer.collect()
    Timer.acc_reset()
    try:
        with Timer("commit"):
            got = decode1(M.msm(affine(pts), sc))
        labels = {lbl for lbl, _ in Timer.acc_records()}
    finally:
        Timer.collect(False)
        Timer.acc_reset()
    assert got == CH.msm(xs, pts)
    assert labels == {f"commit/msm.{s}" for s in (
        "window_digits", "sort_and_bounds", "h3_bucket_sums", "h4_weighted_shares",
        "share_reduction", "horner")}


def test_msm_matches_jax():
    import jax.numpy as jnp

    from spartan_tpu.ops import curve_jax as CJ
    from spartan_tpu.ops import msm as MJ

    n = 70
    pts = points(n)
    xs = scalars(n, 3, zeros=(2,))
    aff = affine(pts)
    sc = F.encode_canonical(xs, "cpu")
    mine = decode1(M.msm(aff, sc))
    jaff = tuple(jnp.asarray(interop.from_port(a)) for a in aff[:2]) + \
        (jnp.asarray(aff[2].numpy()),)
    theirs = CJ.decode_points(tuple(a[None] for a in MJ.msm(jaff, jnp.asarray(
        interop.limbs32_to_16(sc.numpy())))))[0]
    assert mine == theirs == CH.msm(xs, pts)


def test_msm_ladder_path():
    n = 9
    pts = points(n, inf=(4,))
    xs = scalars(n, 5, zeros=(1,))
    assert decode1(M.msm(affine(pts), F.encode_canonical(xs, "cpu"))) == CH.msm(xs, pts)


def test_reduce_points():
    pts = points(7, inf=(2,))
    with DEV.use("cpu"):
        got = decode1(M.reduce_points(CU.encode_points(pts)))
    want = None
    for p in pts:
        want = CH.add(want, p)
    assert got == want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_h3_h4_kernels_match_plain(cuda):
    pts = points(300, inf=(9,))
    aff = tuple(a.to(cuda) for a in affine(pts))
    digits = torch.from_numpy(RNG.integers(0, 128, size=(6, 300)).astype(np.int32)).to(cuda)
    args = M.bucket_inputs(aff, digits, 7)
    k3 = M.launch_msm_bucket(*args)
    assert all(torch.equal(a, b) for a, b in zip(k3, M.bucket_sums_plain(*args)))
    seglen, nseg = M._segments(127)
    k4 = M.launch_msm_weighted(k3, seglen, nseg)
    assert all(torch.equal(a, b) for a, b in zip(k4, M.weighted_shares_plain(k3, seglen, nseg)))
    xs = scalars(300, 9)
    got = CU.decode_points(tuple(a.unsqueeze(0) for a in M.msm(aff, F.encode_canonical(xs, cuda))))
    assert got[0] == CH.msm(xs, pts)
