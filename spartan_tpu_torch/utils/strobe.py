"""STROBE-128 duplex construction, exactly as implemented by the merlin crate.

The reference's Fiat-Shamir transcript is ``merlin::Transcript``
(reference src/transcript.rs), which wraps this mini-STROBE
(STROBE v1.0.2, 128-bit security, Keccak-f[1600], rate 166 bytes).
Bit-compatibility here is what makes our proofs/challenges match the
reference's, so the operation order below (begin_op framing, pad bytes,
run_f triggers) follows the merlin strobe.rs logic precisely.
"""

from __future__ import annotations

from spartan_tpu_torch.ops.keccak import keccak_f1600_bytes

try:
    from spartan_tpu_torch import native as _native

    _bulk_absorb = _native.strobe_absorb_native if _native.available else None
except ImportError:  # pragma: no cover
    _bulk_absorb = None

_STROBE_R = 166  # rate in bytes for security level 128: 1600/8 - 128/4 - 2

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600_bytes(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- internal sponge plumbing -------------------------------------------------

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_STROBE_R + 1] ^= 0x80
        keccak_f1600_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        # A message of a block or more (the R1CS shape digest: tens of MB)
        # is absorbed in one native call; the transcript's short appends
        # keep the loop below, which XORs whole runs up to the rate boundary
        # at once (same bytes as the byte-at-a-time loop).
        i, n = 0, len(data)
        if n >= _STROBE_R and _bulk_absorb is not None:
            from spartan_tpu_torch.utils.timer import Timer  # torch: not at import

            with Timer("strobe.bulk_absorb"):
                self.pos, self.pos_begin = _bulk_absorb(self.state, self.pos,
                                                        self.pos_begin, data)
            return
        while i < n:
            take = min(_STROBE_R - self.pos, n - i)
            end = self.pos + take
            x = int.from_bytes(self.state[self.pos:end], "little") ^ \
                int.from_bytes(data[i:i + take], "little")
            self.state[self.pos:end] = x.to_bytes(take, "little")
            self.pos = end
            i += take
            if self.pos == _STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            assert self.cur_flags == flags, "cannot change flags mid-operation"
            return
        assert flags & FLAG_K == 0, "KEY flag not supported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        # Force F when C (or K) is set and the block already has data.
        if flags & (FLAG_C | FLAG_K) and self.pos != 0:
            self._run_f()

    # -- public STROBE operations used by merlin ----------------------------------

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)
