"""Merlin-compatible Fiat-Shamir transcript.

Host-side, sequential by design: the protocol driver advances one transcript
between device-parallel phases (and, multi-host, every host replays the same
appends so challenges agree — see SURVEY.md section 5).

API mirrors the reference's ``ProofTranscript`` extension trait
(reference src/transcript.rs:14-76) plus the raw merlin methods it
relies on (``append_message``, ``append_u64``, ``challenge_bytes``).
Scalars are Python ints in [0, FR_MOD); points are appended via their
arkworks-compatible compressed bytes by callers.
"""

from __future__ import annotations

from spartan_tpu_torch.ops.fields_host import FR_MOD, fr_from_le_bytes_mod_order, fr_to_bytes
from spartan_tpu_torch.utils.strobe import Strobe128


class Transcript:
    """merlin::Transcript equivalent (STROBE-128 domain-separated sponge)."""

    __slots__ = ("strobe",)

    MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"

    def __init__(self, label: bytes):
        self.strobe = Strobe128(self.MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    # -- merlin core ---------------------------------------------------------------

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, x.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(n.to_bytes(4, "little"), True)
        return self.strobe.prf(n, False)

    # -- Spartan extensions (transcript.rs:37-76) -----------------------------------

    def append_protocol_name(self, protocol_name: bytes) -> None:
        self.append_message(b"protocol-name", protocol_name)

    def append_scalar(self, label: bytes, scalar: int) -> None:
        self.append_message(label, fr_to_bytes(scalar % FR_MOD))

    def append_scalars(self, label: bytes, scalars) -> None:
        for s in scalars:
            self.append_scalar(label, s)

    def append_point(self, label: bytes, compressed: bytes) -> None:
        """Append a compressed group element (transcript.rs:52-54, 102-109)."""
        self.append_message(label, compressed)

    def challenge_scalar(self, label: bytes) -> int:
        """64 challenge bytes reduced mod r (transcript.rs:56-67)."""
        return fr_from_le_bytes_mod_order(self.challenge_bytes(label, 64))

    def challenge_vector(self, label: bytes, n: int) -> list[int]:
        return [self.challenge_scalar(label) for _ in range(n)]
