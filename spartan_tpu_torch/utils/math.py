"""Power-of-two bookkeeping helpers.

Counterpart of the reference's ``Math`` trait
(reference src/math.rs:4-27): ``log_2``, ``pow2``, ``to_bits``,
plus ``next_power_of_two`` used throughout ingestion/padding.
"""

from __future__ import annotations


def log_2(n: int) -> int:
    """Floor of log2(n). Requires n > 0 (matches math.rs:12-15)."""
    assert n > 0
    return n.bit_length() - 1


def pow2(n: int) -> int:
    """2**n (matches math.rs:17-19)."""
    return 1 << n


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n (0 -> 1, Rust semantics for our uses)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def to_bits(val: int, num_bits: int) -> list[bool]:
    """MSB-first bit decomposition (matches math.rs:23-27)."""
    return [(val & (1 << (num_bits - i - 1))) > 0 for i in range(num_bits)]
