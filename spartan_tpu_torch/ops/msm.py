"""Multi-scalar multiplication: Pippenger bucket method on kernels H3 + H4.

Counterpart of ``spartan_tpu/ops/msm.py`` with the sequential Pallas
kernels of ``spartan_tpu/ops/msm_pallas.py``. For each of the W c-bit
windows of every scalar row:

  1. ``window_digits`` splits canonical scalars into c-bit digits;
  2. the digit rows are sorted (``torch.sort``) and each bucket's run of
     equal digits bounded (``torch.searchsorted``); kernel H3
     (``csrc/msm_bucket.cu``) walks every (row, bucket) run with mixed
     additions and writes the bucket sums;
  3. kernel H4 (``csrc/msm_weighted.cu``) forms sum_b b * B_b per row over
     segments of buckets, whose shares are added with H2;
  4. the window sums are combined by a Horner ladder of H2 doublings and
     additions.

While ``Timer.collect()`` is on, each stage's time is accumulated under
the innermost running Timer (``Timer.stage``). Tiny MSMs take a batched
double-and-add ladder instead. Every function
takes the affine generator table (x, y, inf) shared by all rows and
returns projective points. Beside each kernel wrapper is its plain PyTorch
version; a CPU tensor goes to the plain version, a CUDA tensor to the
kernel.
"""

from __future__ import annotations

import torch

from spartan_tpu_torch.ops import curve as CU
from spartan_tpu_torch.ops import kernels as K
from spartan_tpu_torch.ops.limbs import NUM_LIMBS
from spartan_tpu_torch.utils.timer import Timer

# MSMs of at most this many points take the double-and-add ladder
LADDER_N = 64
# digit-row elements (rows x points) per bucket pass: bounds the sort and
# bucket transients (~40 bytes per element)
CHUNK_BUDGET = 1 << 26
# buckets per H4 thread: each segment adds 2 * SEGLEN points plus a short
# double-and-add for its offset
SEGLEN = 16


def window_digits(scalars: torch.Tensor, c: int, num_bits: int = 254) -> torch.Tensor:
    """[..., 8] canonical limbs -> [..., W] c-bit digits, int32 (c <= 31)."""
    assert 1 <= c <= 31
    W = -(-num_bits // c)
    words = scalars.to(torch.int64) & 0xFFFFFFFF
    words = torch.cat((words, torch.zeros_like(words[..., :1])), dim=-1)
    lo = torch.arange(W, device=scalars.device) * c
    li, ofs = lo // 32, lo % 32
    w0 = words[..., li]
    w1 = words[..., li + 1]
    d = ((w0 >> ofs) | (w1 << (32 - ofs))) & ((1 << c) - 1)
    return d.to(torch.int32)


def choose_window(n: int) -> int:
    """Window width for n points: minimizes W(c) * (n + 2^(c+1)), the
    mixed adds of H3 plus the two adds per bucket of H4."""
    best = None
    for c in range(4, 17):
        work = -(-254 // c) * (n + (2 << c))
        if best is None or work < best[0]:
            best = (work, c)
    return best[1]


def reduce_points(p, axis=0):
    """Tree-reduce an axis of a batched projective point with complete adds."""
    x, y, z = (torch.movedim(a, axis, 0) for a in p)
    n = x.shape[0]
    while n > 1:
        half = n // 2
        s = CU.padd((x[:half], y[:half], z[:half]),
                    (x[half:2 * half], y[half:2 * half], z[half:2 * half]))
        if n - 2 * half:
            x, y, z = (torch.cat((si, a[2 * half:]), dim=0) for si, a in zip(s, (x, y, z)))
        else:
            x, y, z = s
        n = half + (n - 2 * half)
    return (x[0], y[0], z[0])


# ---------------------------------------------------------------------------
# H3: bucket sums
# ---------------------------------------------------------------------------

def bucket_sums_plain(px, py, order, lo, hi):
    """Plain version of H3: the same walk per (row, bucket), vectorized
    over the buckets whose run is still going at each step."""
    B, nb = lo.shape
    acc = [a.reshape(B * nb, NUM_LIMBS).clone() for a in CU.identity((B, nb), px.device)]
    lo_f = lo.reshape(-1).long()
    runs = (hi - lo).reshape(-1)
    steps = int(runs.max()) if runs.numel() else 0
    for k in range(steps):
        act = torch.nonzero(runs > k).squeeze(1)
        idx = order[act // nb, lo_f[act] + k].long()
        new = CU.padd_mixed_plain(tuple(a[act] for a in acc), px[idx], py[idx])
        for a, v in zip(acc, new):
            a[act] = v
    return tuple(a.reshape(B, nb, NUM_LIMBS) for a in acc)


def launch_msm_bucket(px, py, order, lo, hi):
    """H3 on CUDA: px, py [N, 8]; order [B, N]; lo, hi [B, nb] -> [B, nb]."""
    N = px.shape[0]
    B, nb = lo.shape
    dev = px.device
    for name, t, dtype, shape in (("px", px, torch.int32, (N, NUM_LIMBS)),
                                  ("py", py, torch.int32, (N, NUM_LIMBS)),
                                  ("order", order, torch.int32, (B, N)),
                                  ("lo", lo, torch.int32, (B, nb)),
                                  ("hi", hi, torch.int32, (B, nb))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"H3 {name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"H3 {name}: must be on the CUDA device {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"H3 {name}: must be contiguous and 16-byte aligned")
    out = tuple(torch.empty((B, nb, NUM_LIMBS), dtype=torch.int32, device=dev)
                for _ in range(3))
    total = B * nb
    if total == 0:
        return out
    lib = K.lib("msm_bucket")
    rc = lib.msm_bucket_launch(px.data_ptr(), py.data_ptr(), order.data_ptr(),
                               lo.data_ptr(), hi.data_ptr(), N, nb, total,
                               out[0].data_ptr(), out[1].data_ptr(),
                               out[2].data_ptr(), K.stream(dev))
    K.count("msm_bucket")
    K.check(rc, "msm_bucket")
    return out


def bucket_inputs(points, digits, c):
    """Sort each digit row and bound each bucket's run.

    Infinity points are forced to digit 0 (``msm_pallas.py:187``); digit 0
    has no bucket, so neither they nor zero digits are ever added. Rows are
    never padded (each H3 thread reads its own run bounds), so the JAX
    package's padding digit 2^c has nothing to mark here.
    Returns (px, py, order [B, N], lo [B, nb], hi [B, nb]), all int32."""
    px, py, pinf = points
    nb = (1 << c) - 1
    digits = torch.where(pinf.unsqueeze(0), torch.zeros_like(digits), digits)
    sd, order = torch.sort(digits, dim=-1, stable=True)
    sd = sd.contiguous()
    q = torch.arange(1, nb + 1, dtype=sd.dtype, device=sd.device)
    q = q.expand(sd.shape[0], nb).contiguous()
    lo = torch.searchsorted(sd, q, side="left").to(torch.int32)
    hi = torch.searchsorted(sd, q, side="right").to(torch.int32)
    return (px.contiguous(), py.contiguous(), order.to(torch.int32).contiguous(),
            lo.contiguous(), hi.contiguous())


def bucket_sums(points, digits, c):
    """Bucket sums of buckets 1..2^c-1 for digit rows [B, N] -> [B, nb]."""
    dev = digits.device
    with Timer.stage("msm.sort_and_bounds", dev):
        args = bucket_inputs(points, digits, c)
    with Timer.stage("msm.h3_bucket_sums", dev):
        if dev.type == "cpu":
            return bucket_sums_plain(*args)
        return launch_msm_bucket(*args)


# ---------------------------------------------------------------------------
# H4: weighted bucket reduction
# ---------------------------------------------------------------------------

def _segments(nb: int) -> tuple[int, int]:
    seglen = min(SEGLEN, nb)
    return seglen, -(-nb // seglen)


def weighted_shares_plain(buckets, seglen: int, nseg: int):
    """Plain version of H4: each (row, segment) share
    sum_{b in seg} (b - first + 1) B_b + (first - 1) * sum_{b in seg} B_b,
    with the kernel's exact sequence of additions and doublings."""
    bx = buckets[0]
    B, nb = bx.shape[0], bx.shape[1]
    dev = bx.device
    first = torch.arange(nseg, device=dev) * seglen + 1
    last = torch.clamp(first + seglen - 1, max=nb)
    run = CU.identity((B, nseg), dev)
    tot = CU.identity((B, nseg), dev)
    for j in range(seglen):
        b = last - j
        active = (b >= first).expand(B, nseg)
        idx = (b - 1).clamp(min=0)
        Bj = tuple(a[:, idx] for a in buckets)
        run2 = CU.padd_plain(run, Bj)
        tot2 = CU.padd_plain(tot, run2)
        run = CU.pselect(active, run2, run)
        tot = CU.pselect(active, tot2, tot)
    k = (first - 1).expand(B, nseg)
    corr = CU.identity((B, nseg), dev)
    for i in range(int(k.max()).bit_length() - 1, -1, -1):
        started = (k >> i) > 0
        corr = CU.pselect(started, CU.pdbl_plain(corr), corr)
        corr = CU.pselect(((k >> i) & 1) == 1, CU.padd_plain(corr, run), corr)
    return CU.padd_plain(tot, corr)


def launch_msm_weighted(buckets, seglen: int, nseg: int):
    """H4 on CUDA: buckets [B, nb] projective -> shares [B, nseg]."""
    bx = buckets[0]
    B, nb = bx.shape[0], bx.shape[1]
    dev = bx.device
    for c in buckets:
        if c.dtype != torch.int32 or tuple(c.shape) != (B, nb, NUM_LIMBS):
            raise ValueError(f"H4: expected int32 {(B, nb, NUM_LIMBS)}, got "
                             f"{c.dtype} {tuple(c.shape)}")
        if c.device != dev or dev.type != "cuda":
            raise ValueError("H4: buckets must be on one CUDA device")
        if not c.is_contiguous() or c.data_ptr() % 16:
            raise ValueError("H4: buckets must be contiguous and 16-byte aligned")
    if seglen <= 0 or seglen * nseg < nb:
        raise ValueError(f"H4: {nseg} segments of {seglen} do not cover {nb} buckets")
    out = tuple(torch.empty((B, nseg, NUM_LIMBS), dtype=torch.int32, device=dev)
                for _ in range(3))
    total = B * nseg
    if total == 0:
        return out
    lib = K.lib("msm_weighted")
    rc = lib.msm_weighted_launch(*(c.data_ptr() for c in buckets), nb, seglen, nseg,
                                 total, *(o.data_ptr() for o in out), K.stream(dev))
    K.count("msm_weighted")
    K.check(rc, "msm_weighted")
    return out


def weighted_sums(buckets, c: int):
    """Per-row sum_b b * B_b of bucket sums [B, 2^c - 1] -> projective [B]."""
    seglen, nseg = _segments((1 << c) - 1)
    dev = buckets[0].device
    with Timer.stage("msm.h4_weighted_shares", dev):
        if dev.type == "cpu":
            shares = weighted_shares_plain(buckets, seglen, nseg)
        else:
            shares = launch_msm_weighted(tuple(a.contiguous() for a in buckets), seglen, nseg)
    with Timer.stage("msm.share_reduction", dev):
        return reduce_points(shares, axis=1)


def bucket_windows(points, digits, c: int):
    """Window sums for a batch of digit rows [B, N] -> projective [B]."""
    return weighted_sums(bucket_sums(points, digits, c), c)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def _horner_windows(window_pts, c: int):
    """Combine window sums (axis 0, most-significant first) by Horner ladder."""
    x, y, z = window_pts
    acc = (x[0], y[0], z[0])
    for w in range(1, x.shape[0]):
        for _ in range(c):
            acc = CU.pdbl(acc)
        acc = CU.padd(acc, (x[w], y[w], z[w]))
    return acc


def msm_ladder(points, scalars):
    """Small-N path: batched double-and-add ladders + tree reduction."""
    px, py, pinf = points
    prods = CU.scalar_mul(scalars, CU.from_affine(px, py, pinf))
    return reduce_points(prods, axis=scalars.dim() - 2)


def msm(points, scalars, c: int | None = None):
    """MSM driver. points: affine (x, y, inf) [N]; scalars [..., N, 8]
    canonical. Returns a projective point with batch shape scalars.shape[:-2].
    The (window x row) digit rows are chunked to bound transients."""
    n = scalars.shape[-2]
    batch_shape = scalars.shape[:-2]
    if n <= LADDER_N:
        return msm_ladder(points, scalars)
    if c is None:
        c = choose_window(n)
    B = 1
    for s in batch_shape:
        B *= s
    with Timer.stage("msm.window_digits", scalars.device):
        digits = window_digits(scalars.reshape(B, n, NUM_LIMBS), c)   # [B, n, W]
        W = digits.shape[-1]
        dig = digits.permute(2, 0, 1).reshape(W * B, n)   # window-major rows
    rows_per_call = min(max(1, CHUNK_BUDGET // n), W * B)
    parts = [bucket_windows(points, dig[s:s + rows_per_call], c)
             for s in range(0, W * B, rows_per_call)]
    win = tuple(torch.cat([p[i] for p in parts], dim=0).reshape(W, B, NUM_LIMBS).flip(0)
                for i in range(3))
    with Timer.stage("msm.horner", scalars.device):
        acc = _horner_windows(win, c)
    return tuple(a.reshape(*batch_shape, NUM_LIMBS) for a in acc)
