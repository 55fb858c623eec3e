"""Exact host-side BN254 G1 arithmetic + arkworks-compatible serialization.

Replaces arkworks ``ark_bn254::G1Projective`` for the control plane (tiny
MSMs in tests, golden values for device-kernel tests, compress/decompress of
proof points). All heavy curve math runs on device via
:mod:`spartan_tpu_torch.ops.curve` / :mod:`spartan_tpu_torch.ops.msm`.

Serialization matches ark-serialize compressed form used throughout the
reference (reference src/group.rs:135-140, 185-190): 32 bytes =
little-endian x with 2 flag bits in the top of byte 31 — bit 6 set for the
point at infinity (x serialized as 0), bit 7 set when y > (q-1)/2
("negative" y). Decompression recomputes y = sqrt(x^3 + 3) with
q = 3 mod 4 and picks the root matching the flag.
"""

from __future__ import annotations

from spartan_tpu_torch.ops.fields_host import CURVE_B, FQ_MOD, FR_MOD, fq_inv, fq_to_bytes

# A point is (x, y) with ints in Fq, or None for the identity.
Point = tuple[int, int] | None

GEN: Point = (1, 2)

_INF_FLAG = 1 << 6
_NEG_FLAG = 1 << 7


def is_on_curve(p: Point) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + CURVE_B)) % FQ_MOD == 0


def neg(p: Point) -> Point:
    if p is None:
        return None
    return (p[0], (-p[1]) % FQ_MOD)


def add(p: Point, q: Point) -> Point:
    """Affine addition with full special-casing (host/exact path only)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % FQ_MOD == 0:
            return None
        # doubling
        lam = (3 * x1 * x1) * fq_inv(2 * y1 % FQ_MOD) % FQ_MOD
    else:
        lam = (y2 - y1) * fq_inv((x2 - x1) % FQ_MOD) % FQ_MOD
    x3 = (lam * lam - x1 - x2) % FQ_MOD
    y3 = (lam * (x1 - x3) - y1) % FQ_MOD
    return (x3, y3)


def double(p: Point) -> Point:
    return add(p, p)


# --- Jacobian internals: inversion-free fast path -------------------------
# (X, Y, Z) with x = X/Z^2, y = Y/Z^3; None for identity. ~3 us per op in
# CPython vs ~5 ms for an affine add (each affine add pays a modular
# inversion), which makes host ladders/MSMs usable as the small-size
# fallback that avoids per-shape device traces (see core/hostpath.py).

JPoint = tuple[int, int, int] | None


def _jdbl(p: JPoint) -> JPoint:
    if p is None:
        return None
    X, Y, Z = p
    if Y == 0:
        return None
    q = FQ_MOD
    A = X * X % q
    B = Y * Y % q
    C = B * B % q
    D = 2 * ((X + B) * (X + B) - A - C) % q
    E = 3 * A % q
    F_ = E * E % q
    X3 = (F_ - 2 * D) % q
    Y3 = (E * (D - X3) - 8 * C) % q
    Z3 = 2 * Y * Z % q
    return (X3, Y3, Z3)


def _jadd(p: JPoint, r: JPoint) -> JPoint:
    if p is None:
        return r
    if r is None:
        return p
    q = FQ_MOD
    X1, Y1, Z1 = p
    X2, Y2, Z2 = r
    Z1Z1 = Z1 * Z1 % q
    Z2Z2 = Z2 * Z2 % q
    U1 = X1 * Z2Z2 % q
    U2 = X2 * Z1Z1 % q
    S1 = Y1 * Z2 * Z2Z2 % q
    S2 = Y2 * Z1 * Z1Z1 % q
    if U1 == U2:
        if S1 != S2:
            return None
        return _jdbl(p)
    H = (U2 - U1) % q
    I = 4 * H * H % q
    J = H * I % q
    rr = 2 * (S2 - S1) % q
    V = U1 * I % q
    X3 = (rr * rr - J - 2 * V) % q
    Y3 = (rr * (V - X3) - 2 * S1 * J) % q
    Z3 = (Z1 + Z2) % q
    Z3 = (Z3 * Z3 - Z1Z1 - Z2Z2) % q * H % q
    return (X3, Y3, Z3)


def _to_j(p: Point) -> JPoint:
    return None if p is None else (p[0], p[1], 1)


def _from_j(p: JPoint) -> Point:
    if p is None or p[2] == 0:
        return None
    zi = fq_inv(p[2])
    zi2 = zi * zi % FQ_MOD
    return (p[0] * zi2 % FQ_MOD, p[1] * zi2 % FQ_MOD * zi % FQ_MOD)


def _jneg(p: JPoint) -> JPoint:
    return None if p is None else (p[0], (-p[1]) % FQ_MOD, p[2])


# ---- native (C) fast path -------------------------------------------------

def _native():
    from spartan_tpu_torch import native as N

    return N if N.g1_available else None


def _pack_points(points: list[Point]) -> tuple[bytes, bytes]:
    xy = bytearray(64 * len(points))
    inf = bytearray(len(points))
    for i, p in enumerate(points):
        if p is None:
            inf[i] = 1
        else:
            xy[64 * i:64 * i + 32] = p[0].to_bytes(32, "little")
            xy[64 * i + 32:64 * i + 64] = p[1].to_bytes(32, "little")
    return bytes(xy), bytes(inf)


def _unpack_point(xy: bytes, inf: int) -> Point:
    if inf:
        return None
    return (int.from_bytes(xy[:32], "little"),
            int.from_bytes(xy[32:64], "little"))


def scalar_mul(k: int, p: Point) -> Point:
    k %= FR_MOD
    n = _native()
    if n is not None:
        import ctypes

        if p is None:
            return None
        xy, inf = _pack_points([p])
        out = ctypes.create_string_buffer(64)
        oinf = ctypes.create_string_buffer(1)
        n._lib.g1_scalar_mul(k.to_bytes(32, "little"), xy, inf[0], out, oinf)
        return _unpack_point(out.raw, oinf.raw[0])
    acc: JPoint = None
    base = _to_j(p)
    while k:
        if k & 1:
            acc = _jadd(acc, base)
        base = _jdbl(base)
        k >>= 1
    return _from_j(acc)


def dual_mul_many(a: int, b: int, P: list[Point], Q: list[Point]) -> list[Point]:
    """[a*P_i + b*Q_i for i] — the bullet generator fold, batched."""
    n = _native()
    if n is None:
        return [add(scalar_mul(a, p), scalar_mul(b, q)) for p, q in zip(P, Q)]
    import ctypes

    cnt = len(P)
    pxy, pinf = _pack_points(P)
    qxy, qinf = _pack_points(Q)
    out = ctypes.create_string_buffer(64 * cnt)
    oinf = ctypes.create_string_buffer(cnt)
    n._lib.g1_dual_mul_many(
        (a % FR_MOD).to_bytes(32, "little"), (b % FR_MOD).to_bytes(32, "little"),
        pxy, pinf, qxy, qinf, cnt, out, oinf)
    return [_unpack_point(out.raw[64 * i:64 * i + 64], oinf.raw[i])
            for i in range(cnt)]


def msm(scalars: list[int], points: list[Point]) -> Point:
    """Exact host MSM: shared-doubling interleaved window method.

    C fast path when the native library built (spartan_tpu_torch/native/
    g1_host.c, ~50x the Python Jacobian path); same algorithm either way:
    one 254-double chain shared by all points + one windowed add per point
    per window (w=4).
    """
    n = _native()
    if n is not None:
        import ctypes

        cnt = len(points)
        if cnt == 0:
            return None
        xy, inf = _pack_points(points)
        sc = b"".join((s % FR_MOD).to_bytes(32, "little") for s in scalars)
        out = ctypes.create_string_buffer(64)
        oinf = ctypes.create_string_buffer(1)
        n._lib.g1_msm(sc, xy, inf, cnt, out, oinf)
        return _unpack_point(out.raw, oinf.raw[0])
    W = 4
    TOP = (254 + W - 1) // W * W
    tables = []
    for p in points:
        base = _to_j(p)
        row = [None] * (1 << W)
        for d in range(1, 1 << W):
            row[d] = _jadd(row[d - 1], base)
        tables.append(row)
    ks = [s % FR_MOD for s in scalars]
    acc: JPoint = None
    for shift in range(TOP - W, -W, -W):
        if acc is not None:
            for _ in range(W):
                acc = _jdbl(acc)
        for t, k in zip(tables, ks):
            d = (k >> shift) & ((1 << W) - 1)
            if d:
                acc = _jadd(acc, t[d])
    return _from_j(acc)


def from_uniform_bytes(uniform: bytes) -> Point:
    """64 uniform bytes -> point, the reference's simplified hash-to-group
    (reference src/group.rs:110-132): sha3-256 -> scalar (with a
    "fallback"-prefixed retry on non-canonical bytes, then 1) -> scalar*G.
    """
    import hashlib

    assert len(uniform) == 64
    h = hashlib.sha3_256(uniform).digest()
    v = int.from_bytes(h, "little")
    if v >= FR_MOD:
        h2 = hashlib.sha3_256(b"fallback" + uniform).digest()
        v2 = int.from_bytes(h2, "little")
        v = v2 if v2 < FR_MOD else 1
    return scalar_mul(v, GEN)


def from_uniform_bytes_secure(uniform: bytes) -> Point:
    """64 uniform bytes -> point with UNKNOWN discrete log.

    Rejection-samples x coordinates: sha3-256(uniform || counter) -> x in
    Fq; accept the first x with x^3 + 3 a quadratic residue, taking the
    non-negative root (arkworks SWFlags sign convention). Unlike the
    reference's simplified scalar*G map (group.rs:110-132) nobody can
    compute dlog(P), so Pedersen commitments over these generators are
    binding. BN254 G1 has cofactor 1 — no clearing needed.
    """
    import hashlib

    assert len(uniform) == 64
    ctr = 0
    while True:
        h = hashlib.sha3_256(uniform + ctr.to_bytes(4, "little")).digest()
        x = int.from_bytes(h, "little") % FQ_MOD
        y = fq_sqrt((x * x % FQ_MOD * x + 3) % FQ_MOD)
        if y is not None:
            y = min(y, FQ_MOD - y)  # canonical: non-negative root
            return (x, y)
        ctr += 1


# ---------------------------------------------------------------------------
# arkworks-compatible compressed serialization
# ---------------------------------------------------------------------------

def _y_is_negative(y: int) -> bool:
    """arkworks SWFlags convention: negative iff y > -y, i.e. y > (q-1)/2."""
    return y > FQ_MOD - y


def compress(p: Point) -> bytes:
    if p is None:
        out = bytearray(32)
        out[31] |= _INF_FLAG
        return bytes(out)
    x, y = p
    out = bytearray(fq_to_bytes(x))
    if _y_is_negative(y):
        out[31] |= _NEG_FLAG
    return bytes(out)


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (q = 3 mod 4): a^((q+1)/4); None if non-residue."""
    r = pow(a, (FQ_MOD + 1) // 4, FQ_MOD)
    return r if r * r % FQ_MOD == a % FQ_MOD else None


def decompress(data: bytes) -> Point | None:
    """Inverse of compress. Returns None point for infinity; raises on junk."""
    assert len(data) == 32
    buf = bytearray(data)
    flags = buf[31] & 0xC0
    buf[31] &= 0x3F
    x = int.from_bytes(bytes(buf), "little")
    if flags & _INF_FLAG:
        return None
    if x >= FQ_MOD:
        raise ValueError("x coordinate out of range")
    y2 = (x * x * x + CURVE_B) % FQ_MOD
    y = fq_sqrt(y2)
    if y is None:
        raise ValueError("point not on curve")
    if _y_is_negative(y) != bool(flags & _NEG_FLAG):
        y = FQ_MOD - y
    return (x, y)
