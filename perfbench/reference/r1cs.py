"""The R1CS instance as the plain verifier sees it, worked out from the
benchmark's own matrices: the NIZK's digest and evaluation of A, B, C at
(rx, ry), and the SNARK's commitment to A, B, C (the dense representation
of the lookup argument, committed row by row with Hyrax) and the derefs a
proof at (rx, ry) commits to.
"""

from __future__ import annotations

import zlib

import numpy as np

from perfbench.reference import bn254 as C
from perfbench.reference.bn254 import FR
from perfbench.reference.spartan import EvalGens, eq_table, log2, pow2_ceil
from perfbench.reference.transcript import Transcript

_ENTRY = np.dtype([("r", "<u8"), ("c", "<u8"), ("v", "V32")])


class Matrices:
    """A, B, C in Spartan's column layout (z = vars, 1, inputs, padding),
    each as (rows, cols, vals): two int64 arrays and a list of ints."""

    def __init__(self, num_cons: int, num_vars: int, num_inputs: int, A, B, C_):
        self.num_cons, self.num_vars, self.num_inputs = num_cons, num_vars, num_inputs
        self.mats = [(np.asarray(r, dtype=np.int64), np.asarray(c, dtype=np.int64),
                      [v % FR for v in vals]) for r, c, vals in (A, B, C_)]

    def digest(self) -> bytes:
        """zlib (level 6) of the shape's bincode, Spartan's instance digest."""
        nx, ny = log2(self.num_cons), log2(2 * self.num_vars)
        out = [v.to_bytes(8, "little") for v in (self.num_cons, self.num_vars,
                                                 self.num_inputs)]
        for rows, cols, vals in self.mats:
            out += [nx.to_bytes(8, "little"), ny.to_bytes(8, "little"),
                    len(vals).to_bytes(8, "little")]
            rec = np.empty(len(vals), dtype=_ENTRY)
            rec["r"], rec["c"] = rows, cols
            rec["v"] = np.frombuffer(_le32(vals), dtype="V32")
            out.append(rec.tobytes())
        return zlib.compress(b"".join(out), 6)

    def evaluate(self, rx: list[int], ry: list[int]) -> tuple[int, int, int]:
        ex, ey = eq_table(rx), eq_table(ry)
        out = []
        for rows, cols, vals in self.mats:
            acc = 0
            for r, c, v in zip(rows.tolist(), cols.tolist(), vals):
                acc += v * ex[r] % FR * ey[c]
            out.append(acc % FR)
        return tuple(out)


def _le32(vals: list[int]) -> bytes:
    return b"".join(v.to_bytes(32, "little") for v in vals)


def _limbs(seg) -> np.ndarray:
    """[len, 16] 16-bit limbs of a segment: an int64 array of values below
    2^63, or a list of field elements."""
    if isinstance(seg, np.ndarray):
        out = np.zeros((len(seg), 16), dtype=np.uint16)
        v = seg.astype(np.uint64)
        for a in range(4):
            out[:, a] = (v >> np.uint64(16 * a)) & np.uint64(0xFFFF)
        return out
    return np.frombuffer(_le32(seg), dtype=np.uint16).reshape(-1, 16)


def _compact(vals: list[int]):
    """The values as an int64 array where they all fit one, else the list."""
    return np.array(vals, dtype=np.int64) if max(vals, default=0) < 1 << 63 else vals


def row_dlogs(segments: list, length: int, gen_dlogs: list[int]) -> list[int]:
    """The discrete log of each Hyrax row commitment (zero blinds) of the
    table that ``segments`` concatenate, zero-padded to ``length``:
    ``t_i = sum_j T[i R + j] s_j``. The products go through float64
    matrix products of 16-bit limbs, exact since each sum stays below
    2^53."""
    R = len(gen_dlogs)
    rows = length // R
    g = np.frombuffer(_le32(gen_dlogs), dtype=np.uint16).reshape(R, 16).astype(np.float64)
    flat = [s for s in segments if len(s)]
    total = sum(len(s) for s in flat)
    if total > length or length % R:
        raise ValueError("table does not fit its rows")
    out = []
    block = max(1, (1 << 19) // R)   # rows per block
    seg_i, seg_off = 0, 0
    for i0 in range(0, rows, block):
        n_rows = min(block, rows - i0)
        want = n_rows * R
        parts = []
        while want and seg_i < len(flat):
            seg = flat[seg_i]
            take = min(want, len(seg) - seg_off)
            parts.append(_limbs(seg[seg_off:seg_off + take]))
            seg_off += take
            want -= take
            if seg_off == len(seg):
                seg_i, seg_off = seg_i + 1, 0
        limbs = np.zeros((n_rows * R, 16), dtype=np.uint16)
        if parts:
            got = np.concatenate(parts)
            limbs[:len(got)] = got
        used = np.flatnonzero(limbs.max(axis=0)).tolist()
        L = limbs.reshape(n_rows, R, 16)
        P = np.zeros((n_rows, 16, 16))
        for a in used:
            P[:, a, :] = L[:, :, a].astype(np.float64) @ g
        for i in range(n_rows):
            acc = 0
            for a in used:
                for b in range(16):
                    acc += int(P[i, a, b]) << (16 * (a + b))
            out.append(acc % FR)
    return out


def poly_at(limbs: np.ndarray, points: list[int]) -> list[int]:
    """sum_k c_k x^k mod FR at each x, for coefficients given as [n, 16]
    16-bit limbs, n a power of two. Blocks of L coefficients meet the limbs
    of x^0 .. x^(L-1) in float64 matrix products, exact since each sum stays
    below 2^44; the blocks are then joined by Horner in x^L."""
    n = len(limbs)
    L = min(n, 1 << 12)
    B = n // L
    powers = []
    for x in points:
        pw = [1] * L
        for j in range(1, L):
            pw[j] = pw[j - 1] * x % FR
        powers.append(np.frombuffer(_le32(pw), dtype=np.uint16).reshape(L, 16)
                      .astype(np.float64))
    Q = [np.zeros((B, 31), dtype=np.int64) for _ in points]
    for a in range(16):
        col = limbs[:, a].reshape(B, L).astype(np.float64)
        for q, T in zip(Q, powers):
            q[:, a:a + 16] += (col @ T).astype(np.int64)
    out = []
    for x, q in zip(points, Q):
        xL, acc = pow(x, L, FR), 0
        for row in q[::-1].tolist():
            blk = 0
            for v in reversed(row):
                blk = (blk << 16) + v
            acc = (acc * xL + blk) % FR
        out.append(acc)
    return out


def _timestamps(num_cells: int, addrs: list[np.ndarray]):
    """Spartan's read timestamps of each address stream and the audit
    timestamps, the count carrying over from one stream to the next."""
    base = np.zeros(num_cells, dtype=np.int64)
    reads = []
    for addr in addrs:
        read = np.zeros(len(addr), dtype=np.int64)
        # the k-th access of a cell in this stream reads base + k
        order = np.argsort(addr, kind="stable")
        sa = addr[order]
        first = np.r_[True, sa[1:] != sa[:-1]] if len(sa) else np.zeros(0, bool)
        starts = np.flatnonzero(first)
        rank = np.arange(len(sa)) - np.repeat(starts, np.diff(np.r_[starts, len(sa)]))
        read[order] = base[sa] + rank
        reads.append(read)
        base = base + np.bincount(addr, minlength=num_cells)
    return reads, base


class Commitment:
    """The SNARK's commitment to A, B, C, worked out from the matrices."""

    def __init__(self, m: Matrices, gens: EvalGens):
        self.num_cons, self.num_vars, self.num_inputs = m.num_cons, m.num_vars, m.num_inputs
        nx, ny = log2(m.num_cons), log2(2 * m.num_vars)
        n = pow2_ceil(max(2, max(len(v) for _, _, v in m.mats)))
        self.batch_size, self.num_ops, self.num_mem_cells = 3, n, 1 << max(nx, ny)

        def pad(a):
            out = np.zeros(n, dtype=np.int64)
            out[:len(a)] = a
            return out

        rows = [pad(r) for r, _, _ in m.mats]
        cols = [pad(c) for _, c, _ in m.mats]
        vals = [_compact(v + [0] * (n - len(v))) for _, _, v in m.mats]
        read_r, audit_r = _timestamps(self.num_mem_cells, rows)
        read_c, audit_c = _timestamps(self.num_mem_cells, cols)
        self.derefs_addrs = rows + cols
        ops = rows + read_r + cols + read_c + vals
        self.ops_dlogs = row_dlogs(ops, pow2_ceil(15 * n), gens.ops.gens_n.G)
        self.mem_dlogs = row_dlogs([audit_r, audit_c], 2 * self.num_mem_cells,
                                   gens.mem.gens_n.G)
        self.ops_points = [C.gmul(t) for t in self.ops_dlogs]
        self.mem_points = [C.gmul(t) for t in self.mem_dlogs]

    def derefs_at(self, rx: list[int], ry: list[int], points: list[int]) -> list[int]:
        """The derefs polynomial of a proof at (rx, ry), at each point: its
        coefficients are eq(rx, row) for the row of every entry of A, B and
        C, then eq(ry, col) for the columns, ``num_ops`` an instance, then
        zeros up to a power of two (the port's ``Derefs.comb``)."""
        out = [0] * len(points)
        n = self.num_ops
        for half, r in enumerate((rx, ry)):
            table = np.frombuffer(_le32(eq_table(r)), dtype=np.uint16).reshape(-1, 16)
            for i in range(3):
                shift = (3 * half + i) * n
                vals = poly_at(table[self.derefs_addrs[3 * half + i]], points)
                out = [(o + v * pow(x, shift, FR)) % FR for o, v, x in zip(out, vals, points)]
        return out

    def differing_rows(self, program: dict) -> int:
        """Rows of the program's commitment (``proof.commitment``) that are
        not the reference's, counting any difference of shape as all."""
        head = (program["num_cons"], program["num_vars"], program["num_inputs"],
                program["batch_size"], program["num_ops"], program["num_mem_cells"])
        mine = (self.num_cons, self.num_vars, self.num_inputs, self.batch_size,
                self.num_ops, self.num_mem_cells)
        total = len(self.ops_points) + len(self.mem_points)
        if head != mine or len(program["comb_ops"]) != len(self.ops_points) or \
                len(program["comb_mem"]) != len(self.mem_points):
            return total
        return sum(not C.jeq(a, b) for a, b in zip(
            self.ops_points + self.mem_points, program["comb_ops"] + program["comb_mem"]))

    def append_to_transcript(self, t: Transcript) -> None:
        for label, v in ((b"num_cons", self.num_cons), (b"num_vars", self.num_vars),
                         (b"num_inputs", self.num_inputs), (b"batch_size", self.batch_size),
                         (b"num_ops", self.num_ops), (b"num_mem_cells", self.num_mem_cells)):
            t.append_u64(label, v)
        for label, pts in ((b"comm_comb_ops", self.ops_points),
                           (b"comm_comb_mem", self.mem_points)):
            t.append_message(label, b"poly_commitment_begin")
            for p in pts:
                t.append_point(b"poly_commitment_share", C.compress(p))
            t.append_message(label, b"poly_commitment_end")
