"""BN254 scalars and G1 points over Python integers, for the plain verifier.

Points come in affine form ``(x, y)`` (``None`` is the identity) and are
added in Jacobian form ``(X, Y, Z)``. Serialisation is the arkworks
compressed form the proofs use: 32 bytes of little-endian x, bit 7 of the
last byte set when y > (q - 1) / 2, bit 6 set for the identity.
"""

from __future__ import annotations

FR = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
FQ = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
GEN = (1, 2)

_INF_FLAG = 1 << 6
_NEG_FLAG = 1 << 7


def batch_inv(vals: list[int], mod: int = FR) -> list[int]:
    """Inverses of nonzero values with one modular inversion."""
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % mod
    acc = pow(prefix[-1], -1, mod)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = acc * prefix[i] % mod
        acc = acc * vals[i] % mod
    return out


# -- Jacobian arithmetic (a = 0) ----------------------------------------------

def jdbl(p):
    if p is None:
        return None
    X, Y, Z = p
    if Y == 0:
        return None
    q = FQ
    A = X * X % q
    B = Y * Y % q
    C = B * B % q
    D = 2 * ((X + B) * (X + B) - A - C) % q
    E = 3 * A % q
    X3 = (E * E - 2 * D) % q
    return (X3, (E * (D - X3) - 8 * C) % q, 2 * Y * Z % q)


def jadd(p, r):
    """Sum of two Jacobian points."""
    if p is None:
        return r
    if r is None:
        return p
    q = FQ
    X1, Y1, Z1 = p
    X2, Y2, Z2 = r
    Z1Z1 = Z1 * Z1 % q
    Z2Z2 = Z2 * Z2 % q
    U1 = X1 * Z2Z2 % q
    U2 = X2 * Z1Z1 % q
    S1 = Y1 * Z2 * Z2Z2 % q
    S2 = Y2 * Z1 * Z1Z1 % q
    H = (U2 - U1) % q
    rr = 2 * (S2 - S1) % q
    if H == 0:
        return jdbl(p) if rr == 0 else None
    I = 4 * H * H % q
    J = H * I % q
    V = U1 * I % q
    X3 = (rr * rr - J - 2 * V) % q
    Y3 = (rr * (V - X3) - 2 * S1 * J) % q
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % q
    return (X3, Y3, Z3)


def madd(p, a):
    """Jacobian ``p`` plus affine ``a``."""
    if a is None:
        return p
    if p is None:
        return (a[0], a[1], 1)
    q = FQ
    X1, Y1, Z1 = p
    x2, y2 = a
    Z1Z1 = Z1 * Z1 % q
    U2 = x2 * Z1Z1 % q
    S2 = y2 * Z1 * Z1Z1 % q
    H = (U2 - X1) % q
    rr = 2 * (S2 - Y1) % q
    if H == 0:
        return jdbl(p) if rr == 0 else None
    HH = H * H % q
    I = 4 * HH
    J = H * I % q
    V = X1 * I % q
    X3 = (rr * rr - J - 2 * V) % q
    Y3 = (rr * (V - X3) - 2 * Y1 * J) % q
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % q
    return (X3, Y3, Z3)


def jneg(p):
    return None if p is None else (p[0], (-p[1]) % FQ, p[2])


def to_jac(a):
    return None if a is None else (a[0], a[1], 1)


def to_affine(p):
    if p is None or p[2] % FQ == 0:
        return None
    zi = pow(p[2], -1, FQ)
    zi2 = zi * zi % FQ
    return (p[0] * zi2 % FQ, p[1] * zi2 * zi % FQ)


def jeq(p, r) -> bool:
    """Whether two Jacobian points are the same point."""
    if p is None or r is None:
        return p is None and r is None
    q = FQ
    Z1Z1 = p[2] * p[2] % q
    Z2Z2 = r[2] * r[2] % q
    return (p[0] * Z2Z2 - r[0] * Z1Z1) % q == 0 and \
        (p[1] * Z2Z2 * r[2] - r[1] * Z1Z1 * p[2]) % q == 0


def jmul(k: int, p):
    """k * p for a Jacobian point (double-and-add)."""
    k %= FR
    acc = None
    while k:
        if k & 1:
            acc = jadd(acc, p)
        p = jdbl(p)
        k >>= 1
    return acc


# -- k * G from a table of windows --------------------------------------------

_G_TABLE: list | None = None


def _g_table() -> list:
    """Affine k * 2^(8w) * G for w < 32 and 0 < k < 256 (index k - 1)."""
    global _G_TABLE
    if _G_TABLE is None:
        jac = []
        base = to_jac(GEN)
        for _w in range(32):
            acc = None
            for _k in range(255):
                acc = jadd(acc, base)
                jac.append(acc)
            for _ in range(8):
                base = jdbl(base)
        zinv = batch_inv([p[2] for p in jac], FQ)
        aff = []
        for (X, Y, _Z), zi in zip(jac, zinv):
            zi2 = zi * zi % FQ
            aff.append((X * zi2 % FQ, Y * zi2 * zi % FQ))
        _G_TABLE = aff
    return _G_TABLE


def gmul(k: int):
    """k * G as a Jacobian point."""
    table = _g_table()
    k %= FR
    acc = None
    w = 0
    while k:
        d = k & 255
        if d:
            acc = madd(acc, table[255 * w + d - 1])
        k >>= 8
        w += 1
    return acc


# -- multi-scalar multiplication ------------------------------------------------

def msm(scalars: list[int], points: list) -> tuple | None:
    """sum_i scalars[i] * points[i] over affine points (Pippenger)."""
    pairs = [(s % FR, p) for s, p in zip(scalars, points, strict=True)
             if p is not None and s % FR]
    if not pairs:
        return None
    n = len(pairs)
    c = 4 if n < 32 else max(4, min(13, n.bit_length() - 2))
    mask = (1 << c) - 1
    total = None
    for shift in range(((254 + c - 1) // c) * c - c, -1, -c):
        for _ in range(c):
            total = jdbl(total)
        buckets = [None] * (mask + 1)
        for s, p in pairs:
            d = (s >> shift) & mask
            if d:
                buckets[d] = madd(buckets[d], p)
        run = None
        acc = None
        for d in range(mask, 0, -1):
            if buckets[d] is not None:
                run = jadd(run, buckets[d])
            acc = jadd(acc, run)
        total = jadd(total, acc)
    return total


# -- serialisation --------------------------------------------------------------

def compress(p) -> bytes:
    """Compressed bytes of a Jacobian point."""
    a = to_affine(p)
    if a is None:
        out = bytearray(32)
        out[31] |= _INF_FLAG
        return bytes(out)
    x, y = a
    out = bytearray(x.to_bytes(32, "little"))
    if y > FQ - y:
        out[31] |= _NEG_FLAG
    return bytes(out)


def decompress(data: bytes):
    """Affine point of 32 compressed bytes; raises ValueError on junk."""
    if len(data) != 32:
        raise ValueError("a point takes 32 bytes")
    flags = data[31] & (_INF_FLAG | _NEG_FLAG)
    x = int.from_bytes(bytes(data[:31]) + bytes([data[31] & 0x3F]), "little")
    if flags & _INF_FLAG:
        if x != 0 or flags & _NEG_FLAG:
            raise ValueError("malformed identity")
        return None
    if x >= FQ:
        raise ValueError("x not below the field modulus")
    rhs = (x * x * x + 3) % FQ
    y = pow(rhs, (FQ + 1) // 4, FQ)
    if y * y % FQ != rhs:
        raise ValueError("x is not on the curve")
    if (y > FQ - y) != bool(flags & _NEG_FLAG):
        y = (FQ - y) % FQ
    return (x, y)
