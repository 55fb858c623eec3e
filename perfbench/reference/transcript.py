"""The merlin transcript (STROBE-128 over Keccak-f[1600]) in plain Python.

The permutation is generated once as straight-line code over 25 local
lane variables, which is several times faster in CPython than a loop
over lists; a whole block is absorbed with one integer XOR.
"""

from __future__ import annotations

import struct

from perfbench.reference.bn254 import FR

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation of lane x + 5 y
_ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]
_M = (1 << 64) - 1


def _make_permutation():
    lines = ["def keccak_f(s, RC=RC, M=M):",
             "    " + ", ".join(f"a{i}" for i in range(25)) + " = s",
             "    for rc in RC:"]
    ind = "        "
    for x in range(5):
        lines.append(ind + f"c{x} = a{x} ^ a{x + 5} ^ a{x + 10} ^ a{x + 15} ^ a{x + 20}")
    for x in range(5):
        c = f"c{(x + 1) % 5}"
        lines.append(ind + f"d{x} = c{(x - 1) % 5} ^ ((({c} << 1) | ({c} >> 63)) & M)")
    for x in range(5):
        for y in range(5):
            n, dst = _ROT[x][y], y + 5 * ((2 * x + 3 * y) % 5)
            if n == 0:
                lines.append(ind + f"b{dst} = a{x + 5 * y} ^ d{x}")
            else:
                lines.append(ind + f"t = a{x + 5 * y} ^ d{x}")
                lines.append(ind + f"b{dst} = ((t << {n}) | (t >> {64 - n})) & M")
    for y in range(5):
        for x in range(5):
            i = x + 5 * y
            lines.append(ind + f"a{i} = b{i} ^ (~b{(x + 1) % 5 + 5 * y} & b{(x + 2) % 5 + 5 * y})")
    lines.append(ind + "a0 ^= rc")
    lines.append("    return [" + ", ".join(f"a{i}" for i in range(25)) + "]")
    scope = {"RC": _RC, "M": _M}
    exec("\n".join(lines), scope)
    return scope["keccak_f"]


keccak_f = _make_permutation()

_R = 166  # STROBE-128 rate in bytes
_FLAG_I, _FLAG_A, _FLAG_C, _FLAG_M = 1, 2, 4, 16
_LANES = struct.Struct("<25Q")


class Strobe128:
    """The subset of STROBE that merlin uses (meta_ad, ad, prf)."""

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        self.state = st
        self._permute()
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _permute(self) -> None:
        self.state[:] = _LANES.pack(*keccak_f(_LANES.unpack(self.state)))

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_R + 1] ^= 0x80
        self._permute()
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        view = memoryview(data)
        while len(view):
            n = min(_R - self.pos, len(view))
            seg = self.state[self.pos:self.pos + n]
            x = int.from_bytes(seg, "little") ^ int.from_bytes(view[:n], "little")
            self.state[self.pos:self.pos + n] = x.to_bytes(n, "little")
            self.pos += n
            view = view[n:]
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        while n:
            k = min(_R - self.pos, n)
            out += self.state[self.pos:self.pos + k]
            self.state[self.pos:self.pos + k] = bytes(k)
            self.pos += k
            n -= k
            if self.pos == _R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if self.cur_flags != flags:
                raise ValueError("flags changed inside an operation")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & _FLAG_C and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def copy(self) -> "Strobe128":
        other = Strobe128.__new__(Strobe128)
        other.state = bytearray(self.state)
        other.pos, other.pos_begin, other.cur_flags = self.pos, self.pos_begin, self.cur_flags
        return other


class Transcript:
    """merlin::Transcript with Spartan's scalar and point helpers."""

    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def copy(self) -> "Transcript":
        other = Transcript.__new__(Transcript)
        other.strobe = self.strobe.copy()
        return other

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

    def append_protocol_name(self, name: bytes) -> None:
        self.append_message(b"protocol-name", name)

    def append_scalar(self, label: bytes, s: int) -> None:
        self.append_message(label, (s % FR).to_bytes(32, "little"))

    def append_scalars(self, label: bytes, ss) -> None:
        for s in ss:
            self.append_scalar(label, s)

    def append_point(self, label: bytes, compressed: bytes) -> None:
        self.append_message(label, compressed)

    def challenge_scalar(self, label: bytes) -> int:
        return int.from_bytes(self.challenge_bytes(label, 64), "little") % FR

    def challenge_vector(self, label: bytes, n: int) -> list[int]:
        return [self.challenge_scalar(label) for _ in range(n)]
