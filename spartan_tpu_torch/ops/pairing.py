"""BN254 pairing on host (exact Python ints): KZG verification only.

The reference delegates pairings to arkworks (kzg.rs:213-214, consumed once
per KZG verify); verification is not performance-critical (289 ms in the
reference), so a clean host implementation suffices (SURVEY.md §2.3 item 4).

Tower: Fq2 = Fq[u]/(u^2+1);  Fq6 = Fq2[v]/(v^3 - xi), xi = 9 + u;
Fq12 = Fq6[w]/(w^2 - v).  G2 lives on the D-type twist y^2 = x^3 + 3/xi;
the untwist psi(x, y) = (x*w^2, y*w^3) lands on y^2 = x^3 + 3 over Fq12.
Optimal ate Miller loop over 6t+2 (t = 4965661367192848881) with the two
Frobenius addition steps, then a generic final exponentiation
f^((q^12-1)/r) — simple and exact; a fast hard-part decomposition can be
swapped in later without changing callers.
"""

from __future__ import annotations

from spartan_tpu_torch.ops.fields_host import FQ_MOD as Q, FR_MOD

# BN parameter t and the ate loop count 6t+2
BN_T = 4965661367192848881
ATE_LOOP = 6 * BN_T + 2

# ---------------------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 + 1): elements (a0, a1) = a0 + a1*u
# ---------------------------------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)
XI = (9, 1)  # 9 + u


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_mul(a, b):
    t0 = a[0] * b[0] % Q
    t1 = a[1] * b[1] % Q
    return ((t0 - t1) % Q, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % Q)


def fq2_sqr(a):
    return fq2_mul(a, a)


def fq2_mul_scalar(a, k: int):
    return (a[0] * k % Q, a[1] * k % Q)


def fq2_conj(a):
    return (a[0], (-a[1]) % Q)


def fq2_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % Q, -1, Q)
    return (a[0] * d % Q, (-a[1]) * d % Q)


def fq2_pow(a, e: int):
    r = FQ2_ONE
    base = a
    while e:
        if e & 1:
            r = fq2_mul(r, base)
        base = fq2_sqr(base)
        e >>= 1
    return r


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v] / (v^3 - xi): elements (c0, c1, c2) over Fq2
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def _mul_xi(a):
    """(9 + u) * a in Fq2."""
    return ((9 * a[0] - a[1]) % Q, (9 * a[1] + a[0]) % Q)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(t0, _mul_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)), _mul_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_mul_v(a):
    """v * (c0 + c1 v + c2 v^2) = xi*c2 + c0 v + c1 v^2."""
    return (_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    t0 = fq2_sqr(a0)
    t1 = fq2_sqr(a1)
    t2 = fq2_sqr(a2)
    c0 = fq2_sub(t0, _mul_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(_mul_xi(t2), fq2_mul(a0, a1))
    c2 = fq2_sub(t1, fq2_mul(a0, a2))
    d = fq2_add(fq2_mul(a0, c0), _mul_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))))
    dinv = fq2_inv(d)
    return (fq2_mul(c0, dinv), fq2_mul(c1, dinv), fq2_mul(c2, dinv))


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w] / (w^2 - v): elements (c0, c1) over Fq6
# ---------------------------------------------------------------------------

FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_mul(a, b):
    t0 = fq6_mul(a[0], b[0])
    t1 = fq6_mul(a[1], b[1])
    c0 = fq6_add(t0, fq6_mul_v(t1))
    c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a[0], a[1]), fq6_add(b[0], b[1])), t0), t1)
    return (c0, c1)


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    d = fq6_inv(fq6_sub(fq6_mul(a[0], a[0]), fq6_mul_v(fq6_mul(a[1], a[1]))))
    return (fq6_mul(a[0], d), fq6_neg(fq6_mul(a[1], d)))


def fq12_pow(a, e: int):
    r = FQ12_ONE
    base = a
    while e:
        if e & 1:
            r = fq12_mul(r, base)
        base = fq12_sqr(base)
        e >>= 1
    return r


def _fq12_eq(a, b):
    return a == b


# ---------------------------------------------------------------------------
# G2 (affine over Fq2): y^2 = x^3 + 3/xi
# ---------------------------------------------------------------------------

TWIST_B = fq2_mul((3, 0), fq2_inv(XI))

G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

G2Point = tuple | None  # ((x0,x1),(y0,y1)) or None for infinity


def g2_is_on_curve(p: G2Point) -> bool:
    if p is None:
        return True
    x, y = p
    return fq2_sub(fq2_sqr(y), fq2_add(fq2_mul(fq2_sqr(x), x), TWIST_B)) == FQ2_ZERO


def g2_neg(p: G2Point) -> G2Point:
    if p is None:
        return None
    return (p[0], fq2_neg(p[1]))


def g2_add(p: G2Point, q: G2Point) -> G2Point:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        lam = fq2_mul(fq2_mul_scalar(fq2_sqr(x1), 3), fq2_inv(fq2_mul_scalar(y1, 2)))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sqr(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(k: int, p: G2Point) -> G2Point:
    k %= FR_MOD
    acc: G2Point = None
    base = p
    while k:
        if k & 1:
            acc = g2_add(acc, base)
        base = g2_add(base, base)
        k >>= 1
    return acc


# ---------------------------------------------------------------------------
# pairing: Miller loop over E(Fq12) + final exponentiation
# ---------------------------------------------------------------------------

def _fq12_from_fq(x: int):
    return (((x % Q, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


def _fq12_from_fq2(x):
    return ((x, FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


# w^2 = v, w^3 = v*w
_W2 = (FQ6_ZERO, FQ6_ZERO)  # placeholders built below


def _wpow(k: int):
    """w^k as an Fq12 element."""
    base = (FQ6_ZERO, FQ6_ONE)  # w
    r = FQ12_ONE
    for _ in range(k):
        r = fq12_mul(r, base)
    return r


_W2 = _wpow(2)
_W3 = _wpow(3)


def _untwist(q: G2Point):
    """psi: E'(Fq2) -> E(Fq12), (x, y) -> (x*w^2, y*w^3)."""
    x, y = q
    return (fq12_mul(_fq12_from_fq2(x), _W2), fq12_mul(_fq12_from_fq2(y), _W3))


def _embed_g1(p):
    return (_fq12_from_fq(p[0]), _fq12_from_fq(p[1]))


def _linefunc(p1, p2, t):
    """Line through p1, p2 evaluated at t; all points over Fq12 (affine)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    if y1 == y2:
        three_x1_sq = fq12_mul(_fq12_from_fq(3), fq12_mul(x1, x1))
        m = fq12_mul(three_x1_sq, fq12_inv(fq12_mul(_fq12_from_fq(2), y1)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    return fq12_sub(xt, x1)


def _ec12_add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        three_x1_sq = fq12_mul(_fq12_from_fq(3), fq12_mul(x1, x1))
        m = fq12_mul(three_x1_sq, fq12_inv(fq12_mul(_fq12_from_fq(2), y1)))
    else:
        m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
    x3 = fq12_sub(fq12_sub(fq12_mul(m, m), x1), x2)
    y3 = fq12_sub(fq12_mul(m, fq12_sub(x1, x3)), y1)
    return (x3, y3)


def _fq12_frobenius(a):
    """a^q via generic pow (simple, exact)."""
    return fq12_pow(a, Q)


_FINAL_EXP = (Q ** 12 - 1) // FR_MOD


def miller_loop(q12, p12):
    f = FQ12_ONE
    r = q12
    for i in range(ATE_LOOP.bit_length() - 2, -1, -1):
        f = fq12_mul(fq12_mul(f, f), _linefunc(r, r, p12))
        r = _ec12_add(r, r)
        if (ATE_LOOP >> i) & 1:
            f = fq12_mul(f, _linefunc(r, q12, p12))
            r = _ec12_add(r, q12)
    # Frobenius endomorphism steps (coordinates are over Fq12; phi = x^q)
    q1 = (_fq12_frobenius(q12[0]), _fq12_frobenius(q12[1]))
    nq2 = (_fq12_frobenius(q1[0]), fq12_sub((FQ6_ZERO, FQ6_ZERO), _fq12_frobenius(q1[1])))
    f = fq12_mul(f, _linefunc(r, q1, p12))
    r = _ec12_add(r, q1)
    f = fq12_mul(f, _linefunc(r, nq2, p12))
    return f


def final_exponentiation(f):
    return fq12_pow(f, _FINAL_EXP)


def pairing(p, q: G2Point):
    """e(P, Q): P a G1 affine (x, y) ints or None; Q a G2 point. -> Fq12."""
    if p is None or q is None:
        return FQ12_ONE
    return final_exponentiation(miller_loop(_untwist(q), _embed_g1(p)))


def multi_pairing_eq(pairs_l, pairs_r) -> bool:
    """prod e(Pi, Qi) == prod e(Pj, Qj) without per-side final exps."""
    f = FQ12_ONE
    for p, q in pairs_l:
        if p is None or q is None:
            continue
        f = fq12_mul(f, miller_loop(_untwist(q), _embed_g1(p)))
    g = FQ12_ONE
    for p, q in pairs_r:
        if p is None or q is None:
            continue
        g = fq12_mul(g, miller_loop(_untwist(q), _embed_g1(p)))
    return final_exponentiation(fq12_mul(f, fq12_inv(g))) == FQ12_ONE
