"""Batched BN254 G1 arithmetic in PyTorch, on kernel H2.

Points are homogeneous projective (X:Y:Z) tuples over Fq, each coordinate
an int32 ``[..., 8]`` Montgomery limb tensor; the identity is (0:1:0).
Affine points are (x, y, inf) with a boolean mask. ``padd`` and ``pdbl``
are the complete Renes-Costello-Batina formulas for a = 0 (RCB 2016
Alg 7 and 9, b3 = 9): one branch-free formula covers generic adds,
doublings, negatives and the identity. On a CUDA tensor they launch
``csrc/curve_ew.cu`` (H2), which replaces the JAX package's Pallas
``make_curve_kernels`` (``spartan_tpu/ops/pallas_field.py:500-548``); on a
CPU tensor they run the plain PyTorch versions below. The two ladders
built from them, ``horner`` (the MSM's window combine) and ``scalar_mul``
(double-and-add), are one H2 launch each, whose plain versions are the
loops of the plain formulas in the same order: kernel and plain version
agree on (X:Y:Z) bit for bit.

The plain versions compute the same formulas with lazy field arithmetic:
sums and differences stay unreduced int64 columns (a difference adds a
multiple of p with large columns first), and only the two layers of
multiplications and the three outputs are reduced. Every reduction is
exact, so the outputs are the kernel's canonical limbs bit for bit.
"""

from __future__ import annotations

import torch

from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import kernels as K
from spartan_tpu_torch.ops.fields_host import FQ_MOD
from spartan_tpu_torch.ops.limbs import NUM_LIMBS, limbs_to_ints

fq = F.fq


# ---------------------------------------------------------------------------
# plain versions (lazy 16-bit-limb arithmetic, any device)
# ---------------------------------------------------------------------------

def padd16(P, Q, C):
    """RCB Alg 7 on canonical 16-limb int64 coordinates (same expressions
    as ``_padd_block_narrow``, multiplications in two batched layers)."""
    mul, sub, red = F.lazy_mul, F.lazy_sub, F.lazy_reduce
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    X1, Y1, Z1, X2, Y2, Z2 = torch.broadcast_tensors(X1, Y1, Z1, X2, Y2, Z2)
    m = mul(torch.stack((X1, Y1, Z1, X1 + Y1, Y1 + Z1, X1 + Z1)),
            torch.stack((X2, Y2, Z2, X2 + Y2, Y2 + Z2, X2 + Z2)), C, 17)
    t0, t1, t2, m01, m12, m02 = m
    t3 = sub(m01, t0 + t1, C)
    t4 = sub(m12, t1 + t2, C)
    y3a = sub(m02, t0 + t2, C)
    t2b3 = 9 * t2
    y3b = 9 * y3a
    t0_3 = 3 * t0
    z3a = t1 + t2b3
    t1b = sub(t1, t2b3, C)
    a_, bb, c_, d_, e_, f_ = mul(torch.stack((t4, t3, y3b, t1b, t0_3, z3a)),
                                 torch.stack((y3b, t1b, t0_3, z3a, t3, t4)), C, 28)
    out = red(torch.stack((sub(bb, a_, C), c_ + d_, f_ + e_)), C, 25)
    return out[0], out[1], out[2]


def padd_mixed16(P, x2, y2, C):
    """RCB Alg 8 (projective + affine, the affine point never the identity)."""
    mul, sub, red = F.lazy_mul, F.lazy_sub, F.lazy_reduce
    X1, Y1, Z1 = P
    X1, Y1, Z1, x2, y2 = torch.broadcast_tensors(X1, Y1, Z1, x2, y2)
    t0, t1, sp, u, v = mul(torch.stack((X1, Y1, x2 + y2, y2, x2)),
                           torch.stack((x2, y2, X1 + Y1, Z1, Z1)), C, 17)
    t3 = sub(sp, t0 + t1, C)
    t4 = u + Y1
    y3 = v + X1
    t0_3 = 3 * t0
    t2 = 9 * Z1
    z3 = t1 + t2
    t1b = sub(t1, t2, C)
    y3b = 9 * y3
    a_, b_, c_, d_, e_, f_ = mul(torch.stack((t3, t4, t1b, y3b, z3, t0_3)),
                                 torch.stack((t1b, y3b, z3, t0_3, t4, t3)), C, 25)
    out = red(torch.stack((sub(a_, b_, C), c_ + d_, e_ + f_)), C, 25)
    return out[0], out[1], out[2]


def pdbl16(P, C):
    """RCB Alg 9 (same expressions as ``_pdbl_block_narrow``)."""
    mul, sub, red = F.lazy_mul, F.lazy_sub, F.lazy_reduce
    X, Y, Z = torch.broadcast_tensors(*P)
    t0, t1, t2, xy = mul(torch.stack((Y, Y, Z, X)), torch.stack((Y, Z, Z, Y)), C, 16)
    z3a = 8 * t0
    t2b3 = 9 * t2
    y3a = t0 + t2b3
    t0c = sub(t0, 3 * t2b3, C)
    x3a, Z3, y3b, x3b = mul(torch.stack((t2b3, t1, t0c, t0c)),
                            torch.stack((z3a, z3a, y3a, xy)), C, 24)
    out = red(torch.stack((x3b + x3b, x3a + y3b, Z3)), C, 25)
    return out[0], out[1], out[2]


_PLAIN_CHUNK = 1 << 16  # points per plain step: bounds the int64 transients


def _plain(f, *coords):
    """Run a 16-limb formula over broadcast int32 coordinates in chunks."""
    coords = torch.broadcast_tensors(*coords)
    shape = coords[0].shape
    flat = [c.reshape(-1, NUM_LIMBS) for c in coords]
    C = F._consts(F.FQ, flat[0].device)
    outs = []
    for i in range(0, flat[0].shape[0], _PLAIN_CHUNK):
        r = f(*(F._to16(c[i:i + _PLAIN_CHUNK]) for c in flat), C)
        outs.append([F._to32(c) for c in r])
    if not outs:
        return tuple(torch.empty(shape, dtype=torch.int32, device=flat[0].device)
                     for _ in range(3))
    return tuple(torch.cat([o[k] for o in outs]).reshape(shape) for k in range(3))


def padd_plain(p, q):
    """Plain version of H2's padd."""
    return _plain(lambda X1, Y1, Z1, X2, Y2, Z2, C: padd16((X1, Y1, Z1), (X2, Y2, Z2), C),
                  *p, *q)


def pdbl_plain(p):
    """Plain version of H2's pdbl."""
    return _plain(lambda X, Y, Z, C: pdbl16((X, Y, Z), C), *p)


def padd_mixed_plain(p, x2, y2):
    """Plain mixed addition (the step of H3's walk)."""
    return _plain(lambda X1, Y1, Z1, x, y, C: padd_mixed16((X1, Y1, Z1), x, y, C),
                  *p, x2, y2)


# ---------------------------------------------------------------------------
# kernel H2 (csrc/curve_ew.cu)
# ---------------------------------------------------------------------------

def _check_coords(coords, n: int) -> None:
    dev = coords[0].device
    for c in coords:
        if c.dtype != torch.int32 or c.shape[-1] != NUM_LIMBS:
            raise ValueError(f"H2: expected int32 [..., {NUM_LIMBS}], got "
                             f"{c.dtype} {tuple(c.shape)}")
        if c.device != dev or dev.type != "cuda":
            raise ValueError("H2: all coordinates must be on one CUDA device")
        if not c.is_contiguous() or c.data_ptr() % 16 or c.numel() != n * NUM_LIMBS:
            raise ValueError("H2: coordinates must be contiguous, 16-byte "
                             f"aligned and hold {n} elements")


def _empty_point(shape, device):
    return tuple(torch.empty(shape, dtype=torch.int32, device=device) for _ in range(3))


def launch_padd(p, q):
    """H2 padd on equal-shaped contiguous CUDA coordinates."""
    shape = p[0].shape
    n = p[0].numel() // NUM_LIMBS
    with K.timed("curve_ew", "padd", n, p[0].device) as launch:
        _check_coords(list(p) + list(q), n)
        out = _empty_point(shape, p[0].device)
        if n == 0:
            return out
        lib = K.lib("curve_ew")
        rc = launch(lib.curve_padd_launch, *(c.data_ptr() for c in (*p, *q, *out)), n,
                    K.stream(p[0].device))
        K.count("curve_ew")
    K.check(rc, "curve_ew padd")
    return out


def launch_pdbl(p):
    """H2 pdbl on equal-shaped contiguous CUDA coordinates."""
    shape = p[0].shape
    n = p[0].numel() // NUM_LIMBS
    with K.timed("curve_ew", "pdbl", n, p[0].device) as launch:
        _check_coords(list(p), n)
        out = _empty_point(shape, p[0].device)
        if n == 0:
            return out
        lib = K.lib("curve_ew")
        rc = launch(lib.curve_pdbl_launch, *(c.data_ptr() for c in (*p, *out)), n,
                    K.stream(p[0].device))
        K.count("curve_ew")
    K.check(rc, "curve_ew pdbl")
    return out


def launch_horner(win, c: int):
    """H2's Horner ladder on contiguous CUDA window sums [W, ..., 8] (most
    significant first): one launch, one thread per row -> [..., 8]."""
    W = win[0].shape[0]
    shape = win[0].shape[1:]
    B = win[0].numel() // (NUM_LIMBS * W) if W else 0
    with K.timed("curve_ew", "horner", B, win[0].device) as launch:
        if W == 0 or c < 0:
            raise ValueError(f"H2 horner: {W} windows of {c} bits")
        _check_coords(list(win), W * B)
        out = _empty_point(shape, win[0].device)
        if B == 0:
            return out
        lib = K.lib("curve_ew")
        rc = launch(lib.curve_horner_launch, *(t.data_ptr() for t in win), W, c, B,
                    *(o.data_ptr() for o in out), K.stream(win[0].device))
        K.count("curve_ew")
    K.check(rc, "curve_ew horner")
    return out


def launch_scalar_mul(scalars_canon, p, num_bits: int):
    """H2's double-and-add ladder on contiguous CUDA operands: scalars
    [..., 8] canonical, points of the same batch shape; one launch, one
    thread per point."""
    shape = p[0].shape
    n = p[0].numel() // NUM_LIMBS
    with K.timed("curve_ew", "scalar_mul", n, p[0].device) as launch:
        _check_coords(list(p) + [scalars_canon], n)
        if not 0 <= num_bits <= 256:
            raise ValueError(f"H2 scalar_mul: {num_bits} bits")
        out = _empty_point(shape, p[0].device)
        if n == 0:
            return out
        lib = K.lib("curve_ew")
        rc = launch(lib.curve_scalar_mul_launch, scalars_canon.data_ptr(), num_bits,
                    *(c.data_ptr() for c in p), n, *(o.data_ptr() for o in out),
                    K.stream(p[0].device))
        K.count("curve_ew")
    K.check(rc, "curve_ew scalar_mul")
    return out


def _same_shape(coords):
    shape = torch.broadcast_shapes(*(c.shape for c in coords))
    return tuple(c.expand(shape).contiguous() for c in coords)


def padd(p, q):
    """Complete projective addition (broadcasting over batch shapes)."""
    if p[0].device.type == "cpu":
        return padd_plain(p, q)
    c = _same_shape(list(p) + list(q))
    return launch_padd(c[:3], c[3:])


def pdbl(p):
    """Complete projective doubling."""
    if p[0].device.type == "cpu":
        return pdbl_plain(p)
    return launch_pdbl(_same_shape(list(p)))


def horner_plain(win, c: int):
    """Plain version of H2's Horner ladder: acc = S_0, then for each later
    window c doublings and acc + S_w, as loops of the plain formulas."""
    x, y, z = win
    acc = (x[0], y[0], z[0])
    for w in range(1, x.shape[0]):
        for _ in range(c):
            acc = pdbl_plain(acc)
        acc = padd_plain(acc, (x[w], y[w], z[w]))
    return acc


def horner(win, c: int):
    """Combine window sums [W, ...] (most significant first) by a Horner
    ladder of c doublings and one addition per window."""
    if win[0].device.type == "cpu":
        return horner_plain(win, c)
    return launch_horner(tuple(a.contiguous() for a in win), c)


def scalar_mul_plain(scalars_canon, p, num_bits: int = 254):
    """Plain version of H2's double-and-add: bits MSB first, one pdbl and
    one padd each, the sum kept where the bit is set."""
    words = scalars_canon.to(torch.int64) & 0xFFFFFFFF
    acc = identity(scalars_canon.shape[:-1], scalars_canon.device)
    for i in range(num_bits - 1, -1, -1):
        acc = pdbl_plain(acc)
        added = padd_plain(acc, p)
        take = ((words[..., i // 32] >> (i % 32)) & 1) == 1
        acc = pselect(take, added, acc)
    return acc


def scalar_mul(scalars_canon, p, num_bits: int = 254):
    """Batched MSB-first double-and-add: scalars [..., 8] canonical limbs
    (int32 bit patterns), points batched to the same leading shape."""
    if scalars_canon.device.type == "cpu":
        return scalar_mul_plain(scalars_canon, p, num_bits)
    c = _same_shape([scalars_canon, *p])
    return launch_scalar_mul(c[0], c[1:], num_bits)


# ---------------------------------------------------------------------------
# point utilities (spartan_tpu/ops/curve_jax.py counterparts)
# ---------------------------------------------------------------------------

def identity(batch_shape=(), device=None):
    return (fq.zeros(batch_shape, device), fq.one(batch_shape, device),
            fq.zeros(batch_shape, device))


def from_affine(x, y, inf_mask=None):
    """Affine limb coords (Montgomery) -> projective; inf_mask selects identity."""
    z = fq.one(x.shape[:-1], x.device)
    if inf_mask is not None:
        m = inf_mask.unsqueeze(-1)
        x = torch.where(m, torch.zeros_like(x), x)
        y = torch.where(m, fq.one(y.shape[:-1], y.device), y)
        z = torch.where(m, torch.zeros_like(z), z)
    return (x, y, z)


def pneg(p):
    X, Y, Z = p
    return (X, fq.neg(Y), Z)


def pselect(mask, p, q):
    """Per-point select: mask [...] bool -> p where true else q."""
    m = mask.unsqueeze(-1)
    return tuple(torch.where(m, a, b) for a, b in zip(p, q))


def batch_normalize(p, host: bool = False):
    """Projective -> (x_affine, y_affine, inf_mask), batch-inverting Z along
    axis 0 (the one inverse of the product on the host if ``host``)."""
    X, Y, Z = p
    zinv = fq.batch_inverse(Z, host)  # zeros stay zero
    x = fq.mul(X, zinv)
    y = fq.mul(Y, zinv)
    inf = fq.is_zero(Z)
    y = torch.where(inf.unsqueeze(-1), fq.one(y.shape[:-1], y.device), y)
    return x, y, inf


# -- host <-> device point conversion ----------------------------------------

def encode_points_affine(points, device=None) -> tuple:
    """List of host affine points ((x, y) or None) -> (x, y, inf) tensors."""
    xs, ys, infs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0)
            ys.append(1)
            infs.append(True)
        else:
            xs.append(pt[0])
            ys.append(pt[1])
            infs.append(False)
    x = F.encode_fq(xs, device)
    return (x, F.encode_fq(ys, device),
            torch.tensor(infs, dtype=torch.bool, device=x.device))


def encode_points(points, device=None) -> tuple:
    """List of host affine points -> projective tensors (identity for None)."""
    return from_affine(*encode_points_affine(points, device))


def decode_few(p) -> list:
    """Projective tensors [k] -> host affine points by one device-to-host
    read of (X, Y, Z) and a Python inverse of each Z: for a few points,
    where ``decode_points``'s device batch inverse costs more."""
    k = p[0].numel() // NUM_LIMBS
    raw = torch.stack([c.reshape(k, NUM_LIMBS) for c in p]).to("cpu").numpy()
    out = []
    for x, y, z in zip(*(limbs_to_ints(raw[i]) for i in range(3))):
        zi = pow(z, -1, FQ_MOD) if z % FQ_MOD else None   # Montgomery factors cancel
        out.append(None if zi is None else (x * zi % FQ_MOD, y * zi % FQ_MOD))
    return out


def decode_points(p) -> list:
    """Projective tensors [n] -> list of host affine points ((x, y) or None)."""
    x, y, inf = batch_normalize(p)
    xs = F.decode_fq(x)
    ys = F.decode_fq(y)
    infs = inf.reshape(-1).tolist()
    return [None if i else (px % FQ_MOD, py % FQ_MOD) for px, py, i in zip(xs, ys, infs)]
