"""Reads Spartan proofs and commitments from their canonical bytes.

The layout is the proofs' serialisation: a scalar is 32 little-endian
bytes below the scalar field's modulus, a point its 32 compressed bytes,
a list or a tuple a u32 count and then its items, an integer a 32-byte
scalar. Objects are plain dicts keyed by the fields' names. Anything
malformed raises ``ValueError``, and so do bytes left over at the end.
"""

from __future__ import annotations

import struct

from perfbench.reference.bn254 import FR, decompress, to_jac


class Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def count(self) -> int:
        n = struct.unpack("<I", self.take(4))[0]
        if n > 1 << 26:
            raise ValueError("length prefix too large")
        return n

    def scalar(self) -> int:
        v = int.from_bytes(self.take(32), "little")
        if v >= FR:
            raise ValueError("scalar not below the modulus")
        return v

    def point(self):
        """A point as a Jacobian tuple (None for the identity)."""
        return to_jac(decompress(self.take(32)))

    def vec(self, item) -> list:
        return [item() for _ in range(self.count())]

    def tup(self, *items) -> tuple:
        if self.count() != len(items):
            raise ValueError("tuple arity")
        return tuple(item() for item in items)

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{len(self.data) - self.pos} bytes left over")


def _scalars(r: Reader) -> list[int]:
    return r.vec(r.scalar)


def _dot_product(r: Reader) -> dict:
    return {"delta": r.point(), "beta": r.point(), "z": _scalars(r),
            "z_delta": r.scalar(), "z_beta": r.scalar()}


def _zk_sumcheck(r: Reader) -> dict:
    return {"comm_polys": r.vec(r.point), "comm_evals": r.vec(r.point),
            "proofs": r.vec(lambda: _dot_product(r))}


def _poly_eval(r: Reader) -> dict:
    return {"L": r.vec(r.point), "R": r.vec(r.point), "delta": r.point(),
            "beta": r.point(), "z1": r.scalar(), "z2": r.scalar()}


def _equality(r: Reader) -> dict:
    return {"alpha": r.point(), "z": r.scalar()}


def r1cs_proof(r: Reader) -> dict:
    out = {"comm_vars": r.vec(r.point), "sc_phase1": _zk_sumcheck(r),
           "claims_phase2": r.tup(r.point, r.point, r.point, r.point)}
    out["pok"], out["prod"] = r.tup(
        lambda: {"alpha": r.point(), "z1": r.scalar(), "z2": r.scalar()},
        lambda: {"alpha": r.point(), "beta": r.point(), "delta": r.point(),
                 "z": _scalars(r)})
    out["eq_phase1"] = _equality(r)
    out["sc_phase2"] = _zk_sumcheck(r)
    out["comm_vars_at_ry"] = r.point()
    out["eval_vars_at_ry"] = _poly_eval(r)
    out["eq_phase2"] = _equality(r)
    return out


def _batched_tree(r: Reader) -> dict:
    layers = r.vec(lambda: {"polys": r.vec(lambda: _scalars(r)),
                            "left": _scalars(r), "right": _scalars(r)})
    return {"layers": layers,
            "claims_dotp": r.tup(lambda: _scalars(r), lambda: _scalars(r),
                                 lambda: _scalars(r))}


def nizk(data: bytes) -> dict:
    r = Reader(data)
    out = {"r1cs": r1cs_proof(r)}
    out["rx"], out["ry"] = r.tup(lambda: _scalars(r), lambda: _scalars(r))
    r.end()
    return out


def snark(data: bytes, pcs: str) -> dict:
    r = Reader(data)
    out = {"r1cs": r1cs_proof(r), "inst_evals": r.tup(r.scalar, r.scalar, r.scalar)}
    out["comm_derefs"] = r.vec(r.point) if pcs == "hyrax" else r.point()
    one = lambda: r.scalar()  # noqa: E731
    vec = lambda: _scalars(r)  # noqa: E731
    out["prod"] = {"eval_row": r.tup(one, vec, vec, one), "eval_col": r.tup(one, vec, vec, one),
                   "eval_val": r.tup(vec, vec), "proof_mem": _batched_tree(r),
                   "proof_ops": _batched_tree(r)}
    out["hash"] = {"eval_row": r.tup(vec, vec, one), "eval_col": r.tup(vec, vec, one),
                   "eval_val": vec(), "eval_derefs": r.tup(vec, vec),
                   "proof_ops": _poly_eval(r), "proof_mem": _poly_eval(r)}
    if pcs == "hyrax":
        out["hash"]["proof_derefs"] = _poly_eval(r)
    else:
        out["hash"]["proof_derefs"] = {"proof": r.point(), "eval": r.scalar()}
    r.end()
    return out


def commitment(data: bytes) -> dict:
    """The SNARK's commitment to A, B and C."""
    r = Reader(data)
    out = {k: r.scalar() for k in ("num_cons", "num_vars", "num_inputs", "batch_size",
                                   "num_ops", "num_mem_cells")}
    out["comb_ops"] = r.vec(r.point)
    out["comb_mem"] = r.vec(r.point)
    r.end()
    return out
