"""Exact host-side BN254 field arithmetic over Python integers.

This is the "control plane" arithmetic: transcript challenges, small
verifier-side algebra, generator derivation, and golden values for testing
the device limb kernels in :mod:`spartan_tpu_torch.ops.field`.

The reference delegates this layer to arkworks (``ark_bn254::Fr``/``Fq``,
reference src/scalar.rs:4-15). We implement it directly: Python ints
are exact, and every hot path runs on-device instead.

Conventions (match arkworks / the reference bit-for-bit):
- ``to_bytes``/``from_bytes``: 32-byte little-endian canonical integer
  (scalar.rs:74-95). ``from_bytes`` returns None for values >= modulus.
- ``from_le_bytes_mod_order``: arbitrary-length LE bytes reduced mod p
  (transcript.rs:56-67 uses 64 bytes).
"""

from __future__ import annotations

# BN254 (a.k.a. alt_bn128) parameters.
# Scalar field modulus r (order of G1/G2), used for Fr:
FR_MOD = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
# Base field modulus q (coordinates live here), used for Fq:
FQ_MOD = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47

# Curve: y^2 = x^3 + 3 over Fq; generator (1, 2); cofactor 1.
CURVE_B = 3
G1_GEN = (1, 2)


def fr_add(a: int, b: int) -> int:
    return (a + b) % FR_MOD


def fr_sub(a: int, b: int) -> int:
    return (a - b) % FR_MOD


def fr_mul(a: int, b: int) -> int:
    return (a * b) % FR_MOD


def fr_neg(a: int) -> int:
    return (-a) % FR_MOD


def fr_inv(a: int) -> int:
    """Multiplicative inverse; raises ZeroDivisionError on 0 like pow()."""
    return pow(a, -1, FR_MOD)


def fr_pow(a: int, e: int) -> int:
    return pow(a, e, FR_MOD)


def fq_inv(a: int) -> int:
    return pow(a, -1, FQ_MOD)


def fr_to_bytes(a: int) -> bytes:
    """Canonical 32-byte LE encoding (scalar.rs:74-84)."""
    assert 0 <= a < FR_MOD
    return a.to_bytes(32, "little")


def fr_from_bytes(b: bytes) -> int | None:
    """Parse canonical 32-byte LE; None if >= modulus (scalar.rs:87-95)."""
    assert len(b) == 32
    v = int.from_bytes(b, "little")
    return v if v < FR_MOD else None


def fr_from_le_bytes_mod_order(b: bytes) -> int:
    """LE bytes of any length reduced mod r (transcript.rs:65)."""
    return int.from_bytes(b, "little") % FR_MOD


def fq_to_bytes(a: int) -> bytes:
    assert 0 <= a < FQ_MOD
    return a.to_bytes(32, "little")


def batch_fr_inv(vals: list[int]) -> list[int]:
    """Montgomery's batch-inversion trick on host (one modular inverse)."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        assert v != 0
        prefix[i + 1] = prefix[i] * v % FR_MOD
    inv = pow(prefix[n], -1, FR_MOD)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = inv * prefix[i] % FR_MOD
        inv = inv * vals[i] % FR_MOD
    return out
