"""Host-side group element wrapper used in proofs and transcripts.

The device does the math; proofs carry host points. This is the analog of
the reference's ``GroupElement``/``CompressedGroup`` pair
(reference src/group.rs:20-24) with arkworks-compatible compressed
serialization (32 bytes, flags in the top bits of the last byte).
"""

from __future__ import annotations

from dataclasses import dataclass

from spartan_tpu_torch.ops import curve_host as CH


@dataclass(frozen=True)
class GroupElem:
    """Affine G1 point on host: ``p`` is (x, y) ints or None for identity."""

    p: CH.Point

    @staticmethod
    def identity() -> "GroupElem":
        return GroupElem(None)

    @staticmethod
    def generator() -> "GroupElem":
        return GroupElem(CH.GEN)

    def compress(self) -> bytes:
        return CH.compress(self.p)

    @staticmethod
    def decompress(data: bytes) -> "GroupElem":
        return GroupElem(CH.decompress(data))

    @staticmethod
    def from_uniform_bytes(uniform: bytes) -> "GroupElem":
        """64 uniform bytes -> point, reproducing the reference's simplified
        hash-to-group (group.rs:110-132) byte-for-byte."""
        return GroupElem(CH.from_uniform_bytes(uniform))

    def append_to_transcript(self, label: bytes, transcript) -> None:
        # GroupElement appends its compressed serialization
        # (transcript.rs:102-109); identical bytes to CompressedGroup appends.
        transcript.append_point(label, self.compress())

    # exact host ops for tests / tiny verifier algebra
    def add(self, other: "GroupElem") -> "GroupElem":
        return GroupElem(CH.add(self.p, other.p))

    def mul(self, k: int) -> "GroupElem":
        return GroupElem(CH.scalar_mul(k, self.p))

    def neg(self) -> "GroupElem":
        return GroupElem(CH.neg(self.p))

    def __eq__(self, other):
        return isinstance(other, GroupElem) and self.p == other.p

    def __hash__(self):
        return hash(self.p)
