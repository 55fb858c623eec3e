"""Circom binary ingestion: `.r1cs` circuits and `.wtns` witnesses.

A copy of ``spartan_tpu/io/r1cs_reader.py``: the reference's
src/r1cs_reader.rs (R1CS binary format v1) and the `.wtns` parser at
examples/keyless_benchmark.rs:38-72. Values are parsed as canonical
32-byte little-endian field elements; entries whose value fails canonical
parsing are dropped silently, matching the reference's behavior
(r1cs_reader.rs:156).

A C fast path (``spartan_tpu_torch.native``) replaces the record walk of
``_parse_constraints`` for multi-million-NNZ circuits without changing
callers. Malformed bytes, truncated ones included, raise
``R1CSParseError``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from spartan_tpu_torch.ops.fields_host import FR_MOD


class R1CSParseError(Exception):
    pass


@dataclass
class R1CSStats:
    num_constraints: int
    num_variables: int
    num_pub_inputs: int
    num_prv_inputs: int
    nnz_a: int
    nnz_b: int
    nnz_c: int


class R1CSFile:
    """Parsed circom R1CS (r1cs_reader.rs:26-93)."""

    def __init__(self, num_constraints, num_variables, num_pub_inputs,
                 num_prv_inputs, num_labels, a, b, c):
        self.num_constraints = num_constraints
        self.num_variables = num_variables
        self.num_pub_inputs = num_pub_inputs
        self.num_prv_inputs = num_prv_inputs
        self.num_labels = num_labels
        self.a = a
        self.b = b
        self.c = c

    @staticmethod
    def from_file(path: str) -> "R1CSFile":
        with open(path, "rb") as f:
            return R1CSFile.from_bytes(f.read())

    @staticmethod
    def from_bytes(data: bytes) -> "R1CSFile":
        try:
            return R1CSFile._from_bytes(data)
        except struct.error as e:
            raise R1CSParseError(f"truncated r1cs data: {e}") from e

    @staticmethod
    def _from_bytes(data: bytes) -> "R1CSFile":
        if data[:4] != b"r1cs":
            raise R1CSParseError("invalid magic number")
        version, num_sections = struct.unpack_from("<II", data, 4)
        if version != 1:
            raise R1CSParseError(f"unsupported version: {version}")

        # index sections: type -> (offset, size)
        sections: dict[int, tuple[int, int]] = {}
        off = 12
        for _ in range(num_sections):
            stype, ssize = struct.unpack_from("<IQ", data, off)
            off += 12
            sections.setdefault(stype, (off, ssize))
            off += ssize

        if 1 not in sections:
            raise R1CSParseError("header section not found")
        hoff, _ = sections[1]
        (field_size,) = struct.unpack_from("<I", data, hoff)
        if field_size != 32:
            raise R1CSParseError(f"invalid field size: {field_size}")
        p = hoff + 4 + field_size
        num_variables, num_pub_outputs, num_pub_inputs, num_prv_inputs = \
            struct.unpack_from("<IIII", data, p)
        (num_labels,) = struct.unpack_from("<Q", data, p + 16)
        (num_constraints,) = struct.unpack_from("<I", data, p + 24)
        total_pub = num_pub_outputs + num_pub_inputs

        if 2 not in sections:
            raise R1CSParseError("constraints section not found")
        coff, _ = sections[2]
        a, b, c = _parse_constraints(data, coff, num_constraints, field_size)

        return R1CSFile(num_constraints, num_variables, total_pub,
                        num_prv_inputs, num_labels, a, b, c)

    def stats(self) -> R1CSStats:
        return R1CSStats(self.num_constraints, self.num_variables,
                         self.num_pub_inputs, self.num_prv_inputs,
                         len(self.a), len(self.b), len(self.c))

    def num_private_vars(self) -> int:
        return self.num_variables - 1 - self.num_pub_inputs

    def to_sparse_matrices_padded(self, num_vars_padded: int):
        """circom -> Spartan column remap (r1cs_reader.rs:213-242):
        const-1 col 0 -> num_vars_padded; publics 1..n_pub -> after the
        constant; privates n_pub+1.. -> from 0."""
        n_pub = self.num_pub_inputs

        def remap(col: int) -> int:
            if col == 0:
                return num_vars_padded
            if col <= n_pub:
                return num_vars_padded + col
            return col - n_pub - 1

        def convert(mat):
            return [(row, remap(col), val) for row, col, val in mat]

        return convert(self.a), convert(self.b), convert(self.c)

    def to_sparse_matrices(self):
        return self.to_sparse_matrices_padded(self.num_private_vars())


def _parse_constraints(data: bytes, off: int, num_constraints: int, field_size: int):
    """Per-constraint [nA, (col,val)*; nB, ...; nC, ...] records.

    Drops non-canonical values silently (matches r1cs_reader.rs:156).
    Dispatches to the C parser (spartan_tpu_torch.native) when available — the
    keyless circuit has 7.1M records.
    """
    try:
        from spartan_tpu_torch.native import r1cs_parse_native

        parsed = r1cs_parse_native(data, off, num_constraints, field_size)
    except ImportError:
        parsed = None
    if parsed is not None:
        mats = []
        for rows, cols, vals_raw in parsed:
            n = rows.shape[0]
            raw = vals_raw.tobytes()
            fs = field_size
            mat = []
            for i in range(n):
                val = int.from_bytes(raw[i * fs:(i + 1) * fs], "little")
                if val < FR_MOD:
                    mat.append((int(rows[i]), int(cols[i]), val))
            mats.append(mat)
        return tuple(mats)
    return _parse_constraints_py(data, off, num_constraints, field_size)


def _parse_constraints_py(data: bytes, off: int, num_constraints: int, field_size: int):
    """The record walk of ``_parse_constraints`` in Python."""
    mats = ([], [], [])
    u32 = struct.Struct("<I")
    pos = off
    for row in range(num_constraints):
        for mat in mats:
            (n,) = u32.unpack_from(data, pos)
            pos += 4
            for _ in range(n):
                (col,) = u32.unpack_from(data, pos)
                val = int.from_bytes(data[pos + 4: pos + 4 + field_size], "little")
                pos += 4 + field_size
                if val < FR_MOD:
                    mat.append((row, col, val))
    return mats


def parse_wtns(path_or_bytes) -> list[int]:
    """`.wtns` witness file -> [1, publics..., privates...] canonical ints
    (examples/keyless_benchmark.rs:38-72)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    if data[:4] != b"wtns" or len(data) < 12:
        raise R1CSParseError("invalid wtns magic")
    (num_sections,) = struct.unpack_from("<I", data, 8)
    off = 12
    out: list[int] = []
    for _ in range(num_sections):
        if off + 12 > len(data):
            break
        sid, ssize = struct.unpack_from("<IQ", data, off)
        off += 12
        if sid == 2:
            n = ssize // 32
            for i in range(n):
                start = off + 32 * i
                if start + 32 > len(data):
                    break
                v = int.from_bytes(data[start: start + 32], "little")
                if v >= FR_MOD:
                    # reference falls back to the low 8 bytes
                    v = int.from_bytes(data[start: start + 8], "little")
                out.append(v)
        off += ssize
    return out


def write_r1cs(path: str, num_variables: int, num_pub: int, num_prv: int,
               constraints: list[tuple[list, list, list]]) -> None:
    """Serialize a circuit back to circom `.r1cs` v1 (test fixtures / interop).

    constraints: per row, three lists of (col, value) in circom column order.
    """
    header = struct.pack("<I", 32) + FR_MOD.to_bytes(32, "little") + struct.pack(
        "<IIIIQI", num_variables, 0, num_pub, num_prv, num_variables, len(constraints))
    body = bytearray()
    for (la, lb, lc) in constraints:
        for entries in (la, lb, lc):
            body += struct.pack("<I", len(entries))
            for col, val in entries:
                body += struct.pack("<I", col) + (val % FR_MOD).to_bytes(32, "little")
    with open(path, "wb") as f:
        f.write(b"r1cs" + struct.pack("<II", 1, 2))
        f.write(struct.pack("<IQ", 1, len(header)) + header)
        f.write(struct.pack("<IQ", 2, len(body)) + bytes(body))


def write_wtns(path: str, witness: list[int]) -> None:
    """Serialize a witness to circom `.wtns` (header section 1 + values)."""
    sec1 = struct.pack("<I", 32) + FR_MOD.to_bytes(32, "little") + struct.pack(
        "<I", len(witness))
    sec2 = b"".join((v % FR_MOD).to_bytes(32, "little") for v in witness)
    with open(path, "wb") as f:
        f.write(b"wtns" + struct.pack("<II", 2, 2))
        f.write(struct.pack("<IQ", 1, len(sec1)) + sec1)
        f.write(struct.pack("<IQ", 2, len(sec2)) + sec2)
