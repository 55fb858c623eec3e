"""Keccak-f[1600] permutation (pure Python, host side).

Backs the STROBE-128 sponge that merlin builds its transcript on
(the reference uses the ``merlin`` crate, reference src/transcript.rs:6).
SHA3-256 / SHAKE-256 (generator derivation, commitments.rs:34-45 and
group.rs:113-115) come from ``hashlib``; only the raw permutation needed by
STROBE is implemented here.

Transcript traffic is a few thousand permutations per proof, so a clean
Python implementation suffices; a C fast path can be swapped in via
:mod:`spartan_tpu_torch.native` without changing callers.
"""

from __future__ import annotations

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_MASK = (1 << 64) - 1

# rotation offsets r[x][y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rol(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(lanes: list[int]) -> list[int]:
    """Apply Keccak-f[1600] to 25 64-bit lanes, A[x + 5y] indexing."""
    a = list(lanes)
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & _MASK & b[(x + 2) % 5 + 5 * y])
        # iota
        a[0] ^= rc
    return a


def _keccak_f1600_bytes_py(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state (little-endian lanes)."""
    assert len(state) == 200
    lanes = [int.from_bytes(state[8 * i: 8 * i + 8], "little") for i in range(25)]
    lanes = keccak_f1600(lanes)
    for i, lane in enumerate(lanes):
        state[8 * i: 8 * i + 8] = lane.to_bytes(8, "little")


# C fast path (spartan_tpu_torch/native): ~50x on the transcript-heavy layers.
try:
    from spartan_tpu_torch import native as _native

    if _native.available:
        keccak_f1600_bytes = _native.keccak_f1600_bytes_native
    else:  # pragma: no cover
        keccak_f1600_bytes = _keccak_f1600_bytes_py
except ImportError:  # pragma: no cover
    keccak_f1600_bytes = _keccak_f1600_bytes_py
