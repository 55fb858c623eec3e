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

from torch_threads import _one_thread  # noqa: F401

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
def test_weighted_segments(seglen):
    """Any segment length L (a power of two with 32 L >= nb) gives
    sum_b b * B_b: the segment walks, the suffix scan over the lanes, the
    doublings by L and the tree."""
    c = 4
    nb = (1 << c) - 1
    bpts = [BASE[i % len(BASE)] if i % 5 else None for i in range(2 * nb)]
    with DEV.use("cpu"):
        buckets = tuple(a.reshape(2, nb, 8) for a in CU.encode_points(bpts))
    lg = seglen.bit_length() - 1
    got = CU.decode_points(M.weighted_sums_plain(buckets, lg, M._lanes_log2(nb, lg)))
    for r in range(2):
        assert got[r] == CH.msm(list(range(1, nb + 1)), bpts[r * nb:(r + 1) * nb])


@pytest.mark.parametrize("nb,lg,ls", [(15, 4, 0), (32, 5, 0), (33, 6, 0), (127, 6, 1),
                                      (1023, 6, 4), (2047, 6, 5), (4095, 7, 5), (65535, 11, 5)])
def test_h4_layout(nb, lg, ls):
    """The one-warp layout: segments of 64 buckets where nb allows, at most
    a warp per row, one level. h4_layout keeps it where the rows' lanes
    fill FILL_WARPS warps, and not for one row of more than 2^FEW_LG_MIN
    buckets."""
    assert M.seglen_log2(nb) == lg and M._lanes_log2(nb, lg) == ls
    assert (1 << (lg + ls)) >= nb
    rows = -(-M.FILL_WARPS * M.LANES >> ls)
    assert M.h4_layout(rows, nb) == (lg, ls)
    assert M.h4_levels(nb, lg, ls) == [(ls, 1, lg)]
    if lg > M.FEW_LG_MIN:
        assert M.h4_layout(rows - 1, nb) != (lg, ls)
        assert M.h4_layout(1, nb)[0] < lg


@pytest.mark.parametrize("rows,nb,lg,ls,levels", [
    # the KZG prove's MSM of 16 windows (one launch) and the smoke's pass of 2
    (16, 65535, 5, 5, [(5, 64, 5), (5, 2, 10), (1, 1, 15)]),
    (2, 65535, 3, 5, [(5, 256, 3), (5, 8, 8), (3, 1, 13)]),
    # a one-row MSM at c = 10: one group at level 1
    (26, 1023, 3, 5, [(5, 4, 3), (2, 1, 8)]),
    # few buckets: one group of fewer lanes
    (51, 31, 3, 2, [(2, 1, 3)])])
def test_h4_layout_few_rows(rows, nb, lg, ls, levels):
    """Rows that do not fill the card take groups of a warp (fewer lanes
    where the row needs fewer) of the largest segment that fills it, else
    of 2^FEW_LG_MIN; further levels combine a row's groups."""
    assert M.h4_layout(rows, nb) == (lg, ls)
    assert M.h4_levels(nb, lg, ls) == levels


@pytest.mark.parametrize("nb,lg,ls", [(0, 3, 5), (255, -1, 5), (255, 25, 0), (255, 3, 6),
                                      (255, 3, -1)])
def test_h4_levels_refuse_what_the_kernel_refuses(nb, lg, ls):
    """h4_levels (which sizes the wrapper's scratch) refuses the layouts
    msm_weighted_launch refuses: nb < 1, lg outside 0..24, ls outside 0..5."""
    with pytest.raises(ValueError):
        M.h4_levels(nb, lg, ls)


def bucket_table(rows, nb, zero_row=False):
    """rows x nb bucket points: generators with every fifth bucket the
    identity, the last row all identity if zero_row."""
    bpts = [BASE[(7 * i) % len(BASE)] if i % 5 else None for i in range(rows * nb)]
    if zero_row:
        bpts[(rows - 1) * nb:] = [None] * nb
    with DEV.use("cpu"):
        return bpts, tuple(a.reshape(rows, nb, 8) for a in CU.encode_points(bpts))


@pytest.mark.parametrize("c", [4, 5, 6, 7, 8])
def test_weighted_sums_few_rows(c, monkeypatch):
    """The few-rows layout (forced at small nb with segments of 1-2
    buckets: up to 8 groups a row, so a second level) for 1, 2 and 3 rows
    equals sum_b b * B_b by host bigints, identity buckets and an all-zero
    row included."""
    monkeypatch.setattr(M, "FEW_LG_MAX", 1)
    monkeypatch.setattr(M, "FEW_LG_MIN", 0)
    nb = (1 << c) - 1
    for rows in (1, 2, 3):
        lg, ls = M.h4_layout(rows, nb)
        assert lg == 0 and len(M.h4_levels(nb, lg, ls)) == (2 if c > 5 else 1)
        bpts, buckets = bucket_table(rows, nb, zero_row=rows == 3)
        got = CU.decode_points(M.weighted_sums(buckets, c))
        for r in range(rows):
            want = None
            for b, p in enumerate(bpts[r * nb:(r + 1) * nb], start=1):
                if p is not None:
                    want = CH.add(want, CH.scalar_mul(b, p))
            assert got[r] == want
        if rows == 3:
            assert got[2] is None


def test_weighted_sums_recursion():
    """More groups a row than one warp combines: 2047 buckets in segments of
    one are 64 groups, combined by a level of 2 groups and a last of 2
    lanes (10 doublings)."""
    nb = 2047
    assert M.h4_levels(nb, 0, 5) == [(5, 64, 0), (5, 2, 5), (1, 1, 10)]
    bpts, buckets = bucket_table(1, nb)
    got = CU.decode_points(M.weighted_sums_plain(buckets, 0, 5))
    assert got == [CH.msm(list(range(1, nb + 1)), bpts)]


@pytest.mark.parametrize("c", [10, 12])
def test_one_row_msm_one_h4_call(c, monkeypatch):
    """The one-launch helper msm() and msm_sharded call, on digit rows of a
    one-row MSM of 2^10 points (its lowest window and its top one, to keep
    the plain versions' work small): H3 fills the bucket table row by
    row (CHUNK_BUDGET lowered to one row), H4 runs once over all the rows,
    and each window sum equals sum_i digit_i * P_i by the host C MSM."""
    n = 1 << 10
    monkeypatch.setattr(M, "CHUNK_BUDGET", n)
    calls = []
    orig = M.weighted_sums
    monkeypatch.setattr(M, "weighted_sums", lambda b, cc: calls.append(b[0].shape) or orig(b, cc))
    pts = points(n, inf=(3,))
    xs = scalars(n, c, zeros=(0, 9))
    digits = M.window_digits(F.encode_canonical(xs, "cpu"), c)   # [n, W]
    dig = digits.t()[[0, -1]].contiguous()
    got = CU.decode_points(M.window_sums(affine(pts), dig, c))
    assert calls == [(2, (1 << c) - 1, 8)]
    assert got == [CH.msm([int(d) for d in row], pts) for row in dig.tolist()]


def test_msm_window_config(monkeypatch):
    """SpartanConfig.msm_window of the default config fixes the window of
    every MSM above the ladder; the value is the same affine point."""
    from spartan_tpu_torch import config

    n = 70
    pts = points(n)
    xs = scalars(n, 8, zeros=(4,))
    sc = F.encode_canonical(xs, "cpu")
    seen = []
    orig = M.window_sums
    monkeypatch.setattr(M, "window_sums", lambda p, d, c: seen.append(c) or orig(p, d, c))
    auto = decode1(M.msm(affine(pts), sc))
    monkeypatch.setattr(config.DEFAULT, "msm_window", 8)
    fixed = decode1(M.msm(affine(pts), sc))
    assert seen == [M.choose_window(n), 8] and M.choose_window(n) != 8
    assert auto == fixed == CH.msm(xs, pts)


def test_infinity_points_get_digit_zero():
    pts = points(8, inf=(1, 5))
    digits = torch.full((2, 8), 3, dtype=torch.int32)
    px, py, order, sd, start = M.bucket_inputs(affine(pts), digits)
    # the infinity points sort first with digit 0 (no bucket), the six
    # finite points of each row follow in bucket 3
    assert start.tolist() == [2, 2]
    assert (sd[:, :2] == 0).all() and (sd[:, 2:] == 3).all()
    assert order[:, :2].tolist() == [[1, 5], [1, 5]]


@pytest.mark.parametrize("tile", [32, 4])
def test_h3_walk_counts(tile, monkeypatch):
    """H3's walk output (plain version): a tile's thread makes one mixed add
    per position but its first, less the runs starting there, so a row of
    one repeated digit gives every full tile TILE - 1 and no more."""
    monkeypatch.setattr(M, "TILE", tile)
    n = 101
    rng = np.random.default_rng(tile)
    digits = np.stack([np.full(n, 5), np.zeros(n), rng.integers(0, 128, size=n)])
    args = M.bucket_inputs(affine(points(n)), torch.from_numpy(digits.astype(np.int32)))
    tpr = -(-n // tile)
    walk = torch.empty(3 * tpr, dtype=torch.int32)
    M.bucket_sums_plain(*args, 127, walk=walk)
    w = walk.reshape(3, tpr).tolist()
    full, rest = divmod(n, tile)
    assert w[0] == [tile - 1] * full + ([rest - 1] if rest else [])
    assert w[1] == [0] * tpr
    sd, st = args[3][2].tolist(), int(args[4][2])
    want = [sum(sd[p] == sd[p - 1] for p in range(p0 + 1, min(p0 + tile, n)))
            if p0 < n else 0 for p0 in range(st, st + tpr * tile, tile)]
    assert w[2] == want and max(w[2]) <= tile - 1


def skewed_row(case, n, rng):
    """One digit row (c = 7) of a skewed kind, and the infinity points."""
    T = M.TILE
    row = rng.integers(1, 128, size=n)
    inf = ()
    if case == "repeated":
        row[:] = 5
    elif case == "zero":
        row[:] = 0
    elif case == "run_of_T":          # a zero prefix, then runs of exactly T
        row = np.concatenate([[0] * 3, [1] * T, [2] * T, rng.integers(3, 128, size=n - 3 - 2 * T)])
    elif case == "run_of_T_plus_1":   # crosses a tile edge
        row = np.concatenate([[4] * (T + 1), rng.integers(5, 128, size=n - T - 1)])
    elif case == "runs_of_1":
        row = rng.permutation(127)[:n] + 1
    elif case == "infinity":
        inf = (0, 7, n - 1)
        row[list(inf)] = 9
    return row, inf


@pytest.mark.parametrize("tile", [32, 4])
@pytest.mark.parametrize("case,n", [("repeated", 101), ("zero", 101), ("run_of_T", 101),
                                    ("run_of_T_plus_1", 101), ("runs_of_1", 101),
                                    ("infinity", 101), ("n_not_multiple_of_T", 70)])
def test_bucket_sums_skewed(case, n, tile, monkeypatch):
    """H3's plain version on skewed rows (with a random row beside): every
    bucket sum equals the sum of its points by the definition, and H4's
    row sums equal the host C MSM. Tiles of 4 force several combine levels."""
    monkeypatch.setattr(M, "TILE", tile)
    rng = np.random.default_rng(len(case) + n + tile)
    row, inf = skewed_row(case, n, rng)
    pts = points(n, inf=inf)
    digits = np.stack([row, rng.integers(0, 128, size=n)]).astype(np.int32)
    args = M.bucket_inputs(affine(pts), torch.from_numpy(digits))
    buckets = M.bucket_sums_plain(*args, 127)
    got = CU.decode_points(tuple(a.reshape(-1, 8) for a in buckets))
    for r in range(2):
        want = [None] * 127
        for d, p in zip(digits[r].tolist(), pts):
            if d and p is not None:
                want[d - 1] = CH.add(want[d - 1], p)
        assert got[r * 127:(r + 1) * 127] == want
    sums = CU.decode_points(M.weighted_sums(buckets, 7))
    assert sums == [CH.msm([int(d) for d in digits[r]], pts) for r in range(2)]


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
        "window_digits", "sort_and_bounds", "h3_bucket_sums", "h4_weighted_sums", "horner")}


def test_kernel_timings_while_collecting(monkeypatch):
    """kernels.timed records a wrapper's launches (CUDA events around each C
    call, the wrapper's host time) only while Timer collects and only on a
    card; counts and recorded launches agree, and reset_counts drops both.
    The card's events are replaced by a fake clock here."""
    import types

    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.utils.timer import Timer

    class Event:
        now = 0.0

        def __init__(self, enable_timing=True):
            self.at = None

        def record(self):
            Event.now += 2.0
            self.at = Event.now

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.at - self.at

    monkeypatch.setattr(torch.cuda, "Event", Event)
    card = types.SimpleNamespace(type="cuda")

    def wrapper(device, n):
        with K.timed("curve_ew", "padd", n, device) as launch:
            if n == 0:
                return 0
            rc = launch(lambda a, b: a + b, n, 1)
            K.count("curve_ew")
        return rc

    K.reset_counts()
    try:
        assert wrapper(card, 5) == 6 and K.timings() == []   # not collecting
        Timer.collect()
        assert [wrapper(card, 5), wrapper(card, 7), wrapper(card, 0),
                wrapper(torch.device("cpu"), 5)] == [6, 8, 0, 6]
        rows = sorted(K.timings(), key=lambda r: r["n"])
        assert [(r["kernel"], r["entry"], r["n"], r["launches"], r["device_ms"])
                for r in rows] == [("curve_ew", "padd", 5, 1, 2.0), ("curve_ew", "padd", 7, 1, 2.0)]
        assert all(r["host_ms"] >= 0 for r in rows)
        assert K.counts()["curve_ew"] == 4
        K.reset_counts()
        assert K.timings() == [] and K.counts()["curve_ew"] == 0
    finally:
        Timer.collect(False)
        K.reset_counts()


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
    digits = RNG.integers(0, 128, size=(8, 300)).astype(np.int32)
    digits[6] = 77    # one repeated digit: a run across every tile of the row
    digits[7] = 0
    args = M.bucket_inputs(aff, torch.from_numpy(digits).to(cuda))
    walk, walk_plain = (torch.empty(8 * -(-300 // M.TILE), dtype=torch.int32, device=cuda)
                        for _ in range(2))
    k3 = M.launch_msm_bucket(*args, 127, walk=walk)
    assert all(torch.equal(a, b) for a, b in zip(k3, M.bucket_sums_plain(*args, 127,
                                                                         walk=walk_plain)))
    assert torch.equal(walk, walk_plain) and int(walk.max()) == M.TILE - 1
    for lg, ls in (M.h4_layout(8, 127), (M.seglen_log2(127), M._lanes_log2(127, 6))):
        k4 = M.launch_msm_weighted(k3, lg, ls)
        assert all(torch.equal(a, b) for a, b in zip(k4, M.weighted_sums_plain(k3, lg, ls)))
        assert CU.decode_points(k4)[6] == CH.msm([77] * 300, pts)
    # one row of 2^16 - 1 buckets (a KZG window): the few-rows layout's
    # three levels
    nb = (1 << 16) - 1
    bpts, table = bucket_table(1, nb)
    table = tuple(a.to(cuda) for a in table)
    lg, ls = M.h4_layout(1, nb)
    assert len(M.h4_levels(nb, lg, ls)) == 3
    k4 = M.launch_msm_weighted(table, lg, ls)
    assert all(torch.equal(a, b) for a, b in zip(k4, M.weighted_sums_plain(table, lg, ls)))
    assert CU.decode_points(k4)[0] == CH.msm(list(range(1, nb + 1)), bpts)
    # the launch function refuses too little scratch for the levels, and
    # groups of more than a warp, before it launches anything
    from spartan_tpu_torch.ops import kernels as K

    need = sum(2 * g for _, g, _ in M.h4_levels(nb, lg, ls)[:-1])
    ptrs = [a.data_ptr() for a in table]
    for l, scratch in ((ls, need - 1), (6, need)):
        assert K.lib("msm_weighted").msm_weighted_launch(
            *ptrs, nb, lg, l, 1, *ptrs, scratch, *(a.data_ptr() for a in k4),
            K.stream(cuda)) != 0
    xs = scalars(300, 9)
    got = CU.decode_points(tuple(a.unsqueeze(0) for a in M.msm(aff, F.encode_canonical(xs, cuda))))
    assert got[0] == CH.msm(xs, pts)
