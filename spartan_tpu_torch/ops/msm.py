"""Multi-scalar multiplication: Pippenger bucket method on kernels H3 + H4.

Counterpart of ``spartan_tpu/ops/msm.py`` with the sequential Pallas
kernels of ``spartan_tpu/ops/msm_pallas.py``. For each of the W c-bit
windows of every scalar row:

  1. ``window_digits`` splits canonical scalars into c-bit digits;
  2. the digit rows are sorted (``torch.sort``); kernel H3
     (``csrc/msm_bucket.cu``) cuts each row's nonzero range into tiles of
     TILE sorted positions, walks each tile with mixed additions (a thread
     never makes more than TILE - 1, however long a bucket's run), and adds
     the pieces of runs cut by tile edges in further tile passes, one level
     up each, into the bucket sums;
  3. kernel H4 (``csrc/msm_weighted.cu``) forms sum_b b * B_b per row: a
     segment of buckets per lane, then a suffix scan, doublings and a tree
     over a group of lanes; a row is one group of up to a warp where the
     rows fill the card, else many warps' groups, combined by further
     levels of the same scan and tree (``h4_layout``). Where an MSM's
     bucket table fits TABLE_BUDGET, H3 fills it in chunks and H4 runs
     once over all of its rows (``window_sums``);
  4. the window sums are combined by H2's Horner ladder (c doublings and
     one addition per window), one launch per MSM.

While ``Timer.collect()`` is on, each stage's time is accumulated under
the innermost running Timer (``Timer.stage``). Tiny MSMs take a batched
double-and-add ladder instead. Every function
takes the affine generator table (x, y, inf) shared by all rows and
returns projective points. Beside each kernel wrapper is its plain PyTorch
version, which makes the kernel's additions in the kernel's order, so the
two agree bit for bit; a CPU tensor goes to the plain version, a CUDA
tensor to the kernel.
"""

from __future__ import annotations

import torch

from spartan_tpu_torch.config import DEFAULT
from spartan_tpu_torch.ops import curve as CU
from spartan_tpu_torch.ops import kernels as K
from spartan_tpu_torch.ops.limbs import NUM_LIMBS
from spartan_tpu_torch.utils.timer import Timer

# MSMs of at most this many points take the double-and-add ladder
LADDER_N = 64
# digit-row elements (rows x points) per bucket pass: bounds the sort and
# bucket transients (~40 bytes per element, and H3's piece slots 200 / TILE)
CHUNK_BUDGET = 1 << 26
# sorted positions per H3 tile: the most points one thread walks
TILE = 32
# H4's one-warp layout: buckets per lane (segment) where the row's buckets
# allow, and the most lanes one group takes (a warp)
SEGLEN = 64
LANES = 32
# H4 keeps the one-warp layout where its lanes fill this many warps, 7 an
# SM of the H100's 132 (it holds 11 an SM at H4's 178 registers; at 2 and
# 16 rows of 65,535 buckets ~1,000 warps were fastest); fewer rows take the
# few-rows layout, segments of 2^FEW_LG_MAX .. 2^FEW_LG_MIN buckets in
# groups of a warp
FILL_WARPS = 132 * 7
FEW_LG_MAX, FEW_LG_MIN = 6, 3
# bytes of an MSM's bucket table [W * B, nb] (96 a bucket) up to which H4
# runs once over all its rows (``window_sums``); larger tables go by chunks
TABLE_BUDGET = 1 << 28


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

def bucket_inputs(points, digits):
    """Sort each digit row.

    Infinity points are forced to digit 0 (``msm_pallas.py:187``); digit 0
    has no bucket, so neither they nor zero digits are ever added. Rows are
    never padded (each H3 tile reads its own row's bounds), so the JAX
    package's padding digit 2^c has nothing to mark here.
    Returns (px, py, order [B, N], sd [B, N], start [B]), all int32: the
    point index and the digit of each sorted position, and each row's
    first nonzero position."""
    px, py, pinf = points
    digits = torch.where(pinf.unsqueeze(0), torch.zeros_like(digits), digits)
    sd, order = torch.sort(digits, dim=-1, stable=True)
    start = (sd == 0).sum(dim=-1, dtype=torch.int32)
    return (px.contiguous(), py.contiguous(), order.to(torch.int32).contiguous(),
            sd.to(torch.int32).contiguous(), start.contiguous())


def _levels(B: int, N: int) -> list:
    """Piece slots read by each of H3's combine levels: two per row tile,
    then two per tile of the level below, until one tile holds them all."""
    n = 2 * B * -(-N // TILE)
    sizes = [n]
    while n > TILE:
        n = 2 * -(-n // TILE)
        sizes.append(n)
    return sizes


def _slots(n: int, dev):
    """A piece buffer: n projective points and their keys (-1: empty)."""
    return (*(torch.zeros((n, NUM_LIMBS), dtype=torch.int32, device=dev) for _ in range(3)),
            torch.full((n,), -1, dtype=torch.int32, device=dev))


def _flush_plain(out, slots, tile, bucket, first, last, nrun, acc):
    """Plain ``flush_run`` for a batch of runs: a finished run to its
    bucket in ``out`` (flat [B * nb]), any other to its tile's first piece
    slot if it is the tile's first run, else to the second."""
    done = torch.nonzero(first & last).squeeze(1)
    for o, a in zip(out, acc):
        o[bucket[done]] = a[done]
    j = torch.nonzero(~(first & last)).squeeze(1)
    slot = 2 * tile[j] + (nrun[j] > 0).long()
    for o, a in zip(slots[:3], acc):
        o[slot] = a[j]
    slots[3][slot] = ((bucket[j] << 2) | first[j].long() | (last[j].long() << 1)).to(torch.int32)


def _tiles_plain(px, py, order, sd, start, nb, out, slots, walk):
    """Plain ``msm_bucket_tiles_kernel``: step j of every live tile at once."""
    B, N = sd.shape
    dev = sd.device
    tpr = -(-N // TILE)
    tile = torch.arange(B * tpr, device=dev)
    row = tile // tpr
    st = start.long()[row]
    p0 = st + (tile % tpr) * TILE
    live = torch.nonzero(p0 < N).squeeze(1)
    tile, row, st, p0 = tile[live], row[live], st[live], p0[live]
    p1 = torch.clamp(p0 + TILE, max=N)
    sdl, ordl = sd.long(), order.long()
    d = sdl[row, p0]
    first = (p0 == st) | (sdl[row, (p0 - 1).clamp(min=0)] != d)
    idx = ordl[row, p0]
    acc = (px[idx], py[idx], CU.fq.one(idx.shape, dev))
    nrun = torch.zeros_like(tile)
    nadd = torch.zeros_like(tile)
    for j in range(1, TILE):
        a = torch.nonzero(p0 + j < p1).squeeze(1)
        if a.numel() == 0:
            break
        p = p0[a] + j
        e = sdl[row[a], p]
        idx = ordl[row[a], p]
        x, y = px[idx], py[idx]
        new = e != d[a]
        n = a[new]
        _flush_plain(out, slots, tile[n], row[n] * nb + d[n] - 1, first[n],
                     torch.ones_like(first[n]), nrun[n], tuple(c[n] for c in acc))
        nrun[n] += 1
        d[n] = e[new]
        first[n] = True
        for c, v in zip(acc, (x[new], y[new], CU.fq.one(n.shape, dev))):
            c[n] = v
        k = a[~new]
        if k.numel():
            for c, v in zip(acc, CU.padd_mixed_plain(tuple(c[k] for c in acc),
                                                     x[~new], y[~new])):
                c[k] = v
            nadd[k] += 1
    if walk is not None:
        walk.zero_()
        walk[tile] = nadd.to(torch.int32)
    last = (p1 == N) | (sdl[row, p1.clamp(max=N - 1)] != d)
    _flush_plain(out, slots, tile, row * nb + d - 1, first, last, nrun, acc)


def _combine_plain(src, n: int, out, dst):
    """Plain ``msm_bucket_combine_kernel`` over the first n slots of src."""
    nt = -(-n // TILE)
    dev = src[3].device
    tiles = torch.arange(nt, device=dev)
    keys = src[3][:n].long()
    cur = torch.full((nt,), -1, dtype=torch.long, device=dev)
    first = torch.zeros(nt, dtype=torch.bool, device=dev)
    last = torch.zeros_like(first)
    nrun = torch.zeros_like(cur)
    acc = CU.identity((nt,), dev)
    for j in range(TILE):
        q = tiles * TILE + j
        a = torch.nonzero((q < n) & (keys[q.clamp(max=n - 1)] >= 0)).squeeze(1)
        if a.numel() == 0:
            continue
        k = keys[q[a]]
        g = k >> 2
        v = tuple(c[q[a]] for c in src[:3])
        new = g != cur[a]
        f = a[new & (cur[a] >= 0)]
        _flush_plain(out, dst, f, cur[f], first[f], last[f], nrun[f], tuple(c[f] for c in acc))
        nrun[f] += 1
        s = a[new]
        for c, w in zip(acc, v):
            c[s] = w[new]
        cur[s] = g[new]
        first[s] = (k[new] & 1) == 1
        o = a[~new]
        if o.numel():
            for c, w in zip(acc, CU.padd_plain(tuple(c[o] for c in acc),
                                               tuple(w[~new] for w in v))):
                c[o] = w
        last[a] = ((k >> 1) & 1) == 1
    f = torch.nonzero(cur >= 0).squeeze(1)
    _flush_plain(out, dst, f, cur[f], first[f], last[f], nrun[f], tuple(c[f] for c in acc))


def bucket_sums_plain(px, py, order, sd, start, nb: int, walk=None):
    """Plain version of H3: the same tiles, pieces and combine levels, in
    the same order of additions, each step vectorized over the tiles; walk
    as in ``launch_msm_bucket``."""
    B, N = sd.shape
    dev = px.device
    out = tuple(a.reshape(B * nb, NUM_LIMBS).clone() for a in CU.identity((B, nb), dev))
    sizes = _levels(B, N)
    src = _slots(sizes[0], dev)
    _tiles_plain(px, py, order, sd, start, nb, out, src, walk)
    for n in sizes:
        if not bool((src[3][:n] >= 0).any()):
            break   # the levels left would find no piece
        dst = _slots(2 * -(-n // TILE), dev)
        _combine_plain(src, n, out, dst)
        src = dst
    return tuple(a.reshape(B, nb, NUM_LIMBS) for a in out)


def launch_msm_bucket(px, py, order, sd, start, nb: int, walk=None, out=None):
    """H3 on CUDA: px, py [N, 8]; order, sd [B, N]; start [B] -> [B, nb],
    into ``out`` if given (three [B, nb, 8]). walk, if given: int32
    [B * ceil(N / TILE)], filled with the mixed adds each tile's thread
    made."""
    N = px.shape[0]
    B = sd.shape[0]
    dev = px.device
    with K.timed("msm_bucket", "bucket_sums", B, dev) as launch:
        checks = [("px", px, (N, NUM_LIMBS)), ("py", py, (N, NUM_LIMBS)),
                  ("order", order, (B, N)), ("sd", sd, (B, N)), ("start", start, (B,))]
        if walk is not None:
            checks.append(("walk", walk, (B * -(-N // TILE),)))
        if out is None:
            out = tuple(torch.empty((B, nb, NUM_LIMBS), dtype=torch.int32, device=dev)
                        for _ in range(3))
        checks += [(f"out {k}", o, (B, nb, NUM_LIMBS)) for k, o in zip("xyz", out)]
        for name, t, shape in checks:
            if t.dtype != torch.int32 or tuple(t.shape) != shape:
                raise ValueError(f"H3 {name}: expected int32 {shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if t.device != dev or dev.type != "cuda":
                raise ValueError(f"H3 {name}: must be on the CUDA device {dev}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"H3 {name}: must be contiguous and 16-byte aligned")
        if (B * nb) << 2 >= 1 << 31:
            raise ValueError(f"H3: {B} rows x {nb} buckets overflow the int32 piece keys")
        if B == 0:
            return out
        sizes = _levels(B, N)
        na, nbuf = sizes[0], 2 * -(-sizes[0] // TILE)
        a = [torch.empty((na, NUM_LIMBS), dtype=torch.int32, device=dev) for _ in range(3)]
        a.append(torch.empty((na,), dtype=torch.int32, device=dev))
        b = [torch.empty((nbuf, NUM_LIMBS), dtype=torch.int32, device=dev) for _ in range(3)]
        b.append(torch.empty((nbuf,), dtype=torch.int32, device=dev))
        lib = K.lib("msm_bucket")
        rc = launch(lib.msm_bucket_launch, px.data_ptr(), py.data_ptr(), order.data_ptr(),
                    sd.data_ptr(), start.data_ptr(), N, nb, B, TILE,
                    *(o.data_ptr() for o in out), *(t.data_ptr() for t in a), na,
                    *(t.data_ptr() for t in b), nbuf,
                    None if walk is None else walk.data_ptr(), K.stream(dev))
        K.count("msm_bucket")
    K.check(rc, "msm_bucket")
    return out


def bucket_sums(points, digits, c, out=None):
    """Bucket sums of buckets 1..2^c-1 for digit rows [B, N] -> [B, nb],
    into ``out`` if given."""
    dev = digits.device
    with Timer.stage("msm.sort_and_bounds", dev):
        args = bucket_inputs(points, digits)
    with Timer.stage("msm.h3_bucket_sums", dev):
        if dev.type != "cpu":
            return launch_msm_bucket(*args, (1 << c) - 1, out=out)
        sums = bucket_sums_plain(*args, (1 << c) - 1)
        if out is None:
            return sums
        for o, a in zip(out, sums):
            o.copy_(a)
        return out


# ---------------------------------------------------------------------------
# H4: weighted bucket reduction
# ---------------------------------------------------------------------------

def _pow2(x: int) -> int:
    """The least power of two >= x (x >= 1)."""
    return 1 << (x - 1).bit_length()


def seglen_log2(nb: int) -> int:
    """log2 of the one-warp layout's segment length L: SEGLEN, less where nb
    is smaller, more where LANES segments of SEGLEN do not cover nb."""
    return (max(min(SEGLEN, _pow2(nb)), _pow2(-(-nb // LANES)))).bit_length() - 1


def _lanes_log2(nb: int, lg: int) -> int:
    """log2 of the one-warp layout's lanes per row: segments of 2^lg to
    cover nb buckets."""
    ls = (_pow2(-(-nb >> lg)) if nb else 1).bit_length() - 1
    if ls > LANES.bit_length() - 1:
        raise ValueError(f"H4: {LANES} segments of 2^{lg} do not cover {nb} buckets")
    return ls


def h4_layout(rows: int, nb: int) -> tuple:
    """(lg, ls) of H4 for rows x nb buckets: segments of 2^lg buckets,
    groups of 2^ls lanes. The one-warp layout (one group covers a row)
    where its lanes fill FILL_WARPS warps; else the few-rows layout: the
    largest lg from FEW_LG_MAX (below the one-warp layout's) down to
    FEW_LG_MIN whose groups fill them (FEW_LG_MIN if none), each group as
    many lanes as the row needs, at most LANES."""
    lg = seglen_log2(nb)
    ls = _lanes_log2(nb, lg)
    if rows << ls >= FILL_WARPS * LANES or lg <= FEW_LG_MIN:
        return lg, ls
    for lg in range(min(FEW_LG_MAX, lg - 1), FEW_LG_MIN - 1, -1):
        ls = min(LANES, _pow2(-(-nb >> lg))).bit_length() - 1
        if rows * (-(-nb >> (lg + ls))) << ls >= FILL_WARPS * LANES:
            break
    return lg, ls


def h4_levels(nb: int, lg: int, ls: int) -> list:
    """H4's levels for segments of 2^lg buckets in groups of 2^ls lanes:
    [(ls, groups a row, doublings)]. Level 0 walks the buckets; each
    further level takes the groups below as its lanes (segments of 2^(dbl +
    ls) buckets), up to LANES to a group, until a row has one group."""
    if not (nb > 0 and 0 <= lg <= 24 and 0 <= ls <= LANES.bit_length() - 1):
        raise ValueError(f"H4: no layout of {nb} buckets in segments of 2^{lg}, "
                         f"groups of 2^{ls} lanes")
    levels = [(ls, -(-nb >> (lg + ls)), lg)]
    while levels[-1][1] > 1:
        l, g, dbl = levels[-1]
        ln = min(LANES, _pow2(g)).bit_length() - 1
        levels.append((ln, -(-g >> ln), dbl + l))
    return levels


def _level_plain(run, tot, dbl: int):
    """Plain version of one level's combine over groups of lanes [X, S]:
    the suffix scan of run, 2^dbl U_s + tot_s, the tree. Returns the
    groups' T [X] and R = U_0 [X]."""
    S = run[0].shape[1]
    acc = run
    o = 1
    while o < S:
        head = CU.padd_plain(tuple(a[:, :S - o] for a in acc), tuple(a[:, o:] for a in acc))
        acc = tuple(torch.cat((h, a[:, S - o:]), dim=1) for h, a in zip(head, acc))
        o *= 2
    r = tuple(a[:, 0] for a in acc)
    acc = tuple(a[:, 1:] for a in acc)
    for _ in range(dbl):
        acc = CU.pdbl_plain(acc)
    y = CU.padd_plain(acc, tuple(t[:, 1:] for t in tot))
    acc = tuple(torch.cat((t[:, :1], v), dim=1) for t, v in zip(tot, y))
    while o > 1:
        o //= 2
        acc = CU.padd_plain(tuple(a[:, :o] for a in acc), tuple(a[:, o:2 * o] for a in acc))
    return tuple(a[:, 0] for a in acc), r


def weighted_sums_plain(buckets, lg: int, ls: int):
    """Plain version of H4 in the layout (lg, ls): the lanes' segment walks,
    then each level's suffix scan, doublings and tree, in the kernel's order
    of additions, vectorized over rows, groups and lanes."""
    bx = buckets[0]
    B, nb = bx.shape[0], bx.shape[1]
    dev = bx.device
    levels = h4_levels(nb, lg, ls)
    S, L = levels[0][1] << ls, 1 << lg   # lanes a row at level 0
    s = torch.arange(S, device=dev)
    lo, hi = s * L + 1, torch.clamp(s * L + L, max=nb)
    run, tot = CU.identity((B, S), dev), CU.identity((B, S), dev)
    for j in range(L):
        lanes = torch.nonzero(hi - j >= lo).squeeze(1)
        if lanes.numel() == 0:
            break
        Bj = tuple(a[:, hi[lanes] - j - 1] for a in buckets)
        if j == 0:
            r2 = t2 = Bj
        else:
            r2 = CU.padd_plain(tuple(a[:, lanes] for a in run), Bj)
            t2 = CU.padd_plain(tuple(a[:, lanes] for a in tot), r2)
        for a, v in zip(run + tot, r2 + t2):
            a[:, lanes] = v
    for l, g, dbl in levels:
        pad = (g << l) - run[0].shape[1]   # lanes past the level's inputs
        if pad:
            run, tot = (tuple(torch.cat((a, e), dim=1) for a, e in zip(p, CU.identity((B, pad), dev)))
                        for p in (run, tot))
        T, R = _level_plain(tuple(a.reshape(B * g, 1 << l, NUM_LIMBS) for a in run),
                              tuple(a.reshape(B * g, 1 << l, NUM_LIMBS) for a in tot), dbl)
        run, tot = (tuple(a.reshape(B, g, NUM_LIMBS) for a in p) for p in (R, T))
    return tuple(a[:, 0] for a in tot)


def launch_msm_weighted(buckets, lg: int, ls: int):
    """H4 on CUDA: buckets [B, nb] projective -> row sums [B], in the
    layout (lg, ls) (``h4_layout``); the levels after the first go through
    scratch, one launch function call for all of them."""
    bx = buckets[0]
    B, nb = bx.shape[0], bx.shape[1]
    dev = bx.device
    with K.timed("msm_weighted", "weighted_sums", B, dev) as launch:
        levels = h4_levels(nb, lg, ls)
        need = sum(2 * B * g for _, g, _ in levels[:-1])
        scratch = tuple(torch.empty((need, NUM_LIMBS), dtype=torch.int32, device=dev)
                        for _ in range(3))
        checks = [(f"buckets {k}", c, (B, nb, NUM_LIMBS)) for k, c in zip("xyz", buckets)] + \
            [(f"scratch {k}", c, (need, NUM_LIMBS)) for k, c in zip("xyz", scratch)]
        for name, c, shape in checks:
            if c.dtype != torch.int32 or tuple(c.shape) != shape:
                raise ValueError(f"H4 {name}: expected int32 {shape}, got "
                                 f"{c.dtype} {tuple(c.shape)}")
            if c.device != dev or dev.type != "cuda":
                raise ValueError(f"H4 {name}: must be on the CUDA device {dev}")
            if not c.is_contiguous() or c.data_ptr() % 16:
                raise ValueError(f"H4 {name}: must be contiguous and 16-byte aligned")
        out = tuple(torch.empty((B, NUM_LIMBS), dtype=torch.int32, device=dev) for _ in range(3))
        if B == 0:
            return out
        lib = K.lib("msm_weighted")
        rc = launch(lib.msm_weighted_launch, *(c.data_ptr() for c in buckets), nb, lg, ls, B,
                    *(c.data_ptr() for c in scratch), need, *(o.data_ptr() for o in out),
                    K.stream(dev))
        K.count("msm_weighted")
    K.check(rc, "msm_weighted")
    return out


def weighted_sums(buckets, c: int):
    """Per-row sum_b b * B_b of bucket sums [B, 2^c - 1] -> projective [B]."""
    lg, ls = h4_layout(buckets[0].shape[0], (1 << c) - 1)
    dev = buckets[0].device
    with Timer.stage("msm.h4_weighted_sums", dev):
        if dev.type == "cpu":
            return weighted_sums_plain(buckets, lg, ls)
        return launch_msm_weighted(tuple(a.contiguous() for a in buckets), lg, ls)


def bucket_windows(points, digits, c: int):
    """Window sums for a batch of digit rows [B, N] -> projective [B]."""
    return weighted_sums(bucket_sums(points, digits, c), c)


def window_sums(points, dig, c: int):
    """Window sums of an MSM's digit rows [R, N] -> projective [R]. H3 takes
    chunks of CHUNK_BUDGET // N rows; where the rows' bucket table fits
    TABLE_BUDGET bytes, H3 writes each chunk into it and H4 runs once over
    all R rows, else H4 runs on each chunk's buckets."""
    R, n = dig.shape
    nb = (1 << c) - 1
    step = min(max(1, CHUNK_BUDGET // n), R)
    if R * nb * 3 * NUM_LIMBS * 4 > TABLE_BUDGET:
        parts = [bucket_windows(points, dig[s:s + step], c) for s in range(0, R, step)]
        return tuple(torch.cat([p[i] for p in parts], dim=0) for i in range(3))
    table = tuple(torch.empty((R, nb, NUM_LIMBS), dtype=torch.int32, device=dig.device)
                  for _ in range(3))
    for s in range(0, R, step):
        bucket_sums(points, dig[s:s + step], c, out=tuple(t[s:s + step] for t in table))
    return weighted_sums(table, c)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def msm_ladder(points, scalars):
    """Small-N path: batched double-and-add ladders + tree reduction."""
    px, py, pinf = points
    prods = CU.scalar_mul(scalars, CU.from_affine(px, py, pinf))
    return reduce_points(prods, axis=scalars.dim() - 2)


def msm(points, scalars, c: int | None = None):
    """MSM driver. points: affine (x, y, inf) [N]; scalars [..., N, 8]
    canonical. Returns a projective point with batch shape scalars.shape[:-2].
    The window is c, else ``SpartanConfig.msm_window`` of the default
    config, else ``choose_window``; the (window x row) digit rows go to
    ``window_sums``."""
    n = scalars.shape[-2]
    batch_shape = scalars.shape[:-2]
    if n <= LADDER_N:
        return msm_ladder(points, scalars)
    if c is None:
        c = DEFAULT.msm_window or choose_window(n)
    B = 1
    for s in batch_shape:
        B *= s
    with Timer.stage("msm.window_digits", scalars.device):
        digits = window_digits(scalars.reshape(B, n, NUM_LIMBS), c)   # [B, n, W]
        W = digits.shape[-1]
        dig = digits.permute(2, 0, 1).reshape(W * B, n)   # window-major rows
    win = tuple(a.reshape(W, B, NUM_LIMBS).flip(0) for a in window_sums(points, dig, c))
    with Timer.stage("msm.horner", scalars.device):
        acc = CU.horner(win, c)
    return tuple(a.reshape(*batch_shape, NUM_LIMBS) for a in acc)
