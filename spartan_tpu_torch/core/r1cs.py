"""R1CS constraint system shape.

Counterpart of the shape part of ``spartan_tpu/core/r1cs.py`` (reference
r1cs.rs:23-160): the shape, satisfiability check, MLE evaluation, digest,
and the phase-1/phase-2 table builders; and the SNARK-mode commitment to
A, B, C with its evaluation proof (r1cs.rs:263-491), its derefs committed
by Hyrax or KZG (``R1CSCommitmentGens(..., pcs=)``).
"""

from __future__ import annotations

import zlib

import numpy as np

from spartan_tpu_torch.core.mle import DensePolynomial
from spartan_tpu_torch.core.sparse_mlpoly import SparseMatPolynomial
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.utils.math import is_power_of_two, log_2, next_power_of_two
from spartan_tpu_torch.utils.timer import Timer

fr = F.fr

_ENTRY = np.dtype([("r", "<u8"), ("c", "<u8"), ("v", "V32")])


class R1CSShape:
    """num_cons x (2*num_vars) R1CS with power-of-two dims (r1cs.rs:23-82)."""

    def __init__(self, num_cons: int, num_vars: int, num_inputs: int,
                 A: list[tuple[int, int, int]], B: list[tuple[int, int, int]],
                 C: list[tuple[int, int, int]]):
        assert is_power_of_two(num_cons), "num_cons must be a power of 2"
        assert is_power_of_two(num_vars), "num_vars must be a power of 2"
        assert num_inputs < num_vars, "num_inputs must be less than num_vars"
        self.num_cons = num_cons
        self.num_vars = num_vars
        self.num_inputs = num_inputs
        nx = log_2(num_cons)
        ny = log_2(2 * num_vars)

        def build(tups):
            return SparseMatPolynomial.from_arrays(
                nx, ny, rows=[t[0] for t in tups], cols=[t[1] for t in tups],
                vals=[t[2] for t in tups])

        self.A = build(A)
        self.B = build(B)
        self.C = build(C)

    def get_num_vars(self) -> int:
        return self.num_vars

    def get_num_cons(self) -> int:
        return self.num_cons

    def get_num_inputs(self) -> int:
        return self.num_inputs

    def bincode_bytes(self) -> bytes:
        """bincode-1.x legacy encoding of the shape, byte-identical to the
        reference's ``bincode::serialize_into(&self)`` (r1cs.rs:98-99):
        fixed-width little-endian u64 for usize, u64 length prefixes for
        Vec, Scalar as its 32-byte LE serde form, field order = struct
        order (num_cons, num_vars, num_inputs, A, B, C; each
        SparseMatPolynomial = num_vars_x, num_vars_y, M). The entries are
        packed through one numpy record array instead of a Python loop."""
        out = bytearray()
        for v in (self.num_cons, self.num_vars, self.num_inputs):
            out += v.to_bytes(8, "little")
        for mat in (self.A, self.B, self.C):
            out += mat.num_vars_x.to_bytes(8, "little")
            out += mat.num_vars_y.to_bytes(8, "little")
            out += len(mat.vals).to_bytes(8, "little")
            rec = np.empty(len(mat.vals), dtype=_ENTRY)
            rec["r"] = mat.rows
            rec["c"] = mat.cols
            rec["v"] = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in mat.vals),
                                     dtype="V32")
            out += rec.tobytes()
        return bytes(out)

    def get_digest(self) -> bytes:
        """zlib(bincode(shape)) at level 6, the reference's digest
        (r1cs.rs:97-101)."""
        return zlib.compress(self.bincode_bytes(), 6)

    def build_z(self, vars_: list[int], inputs: list[int]) -> list[int]:
        """z = (vars, 1, inputs, 0-padding) to length 2*num_vars."""
        assert len(vars_) == self.num_vars
        z = list(vars_) + [1] + list(inputs)
        z += [0] * (2 * self.num_vars - len(z))
        return z

    def build_z_device(self, vars_mont, inputs_mont):
        """``build_z`` on the device from the encoded witness: [2*num_vars,
        8] Montgomery limbs of (vars, 1, inputs, 0-padding), no host ints."""
        n = self.num_vars
        assert vars_mont.shape[0] == n
        z = fr.zeros((2 * n,), vars_mont.device)
        z[:n] = vars_mont
        z[n] = fr.one((), vars_mont.device)
        z[n + 1:n + 1 + inputs_mont.shape[0]] = inputs_mont
        return z

    def is_sat(self, vars_: list[int], inputs: list[int], device=None) -> bool:
        assert len(vars_) == self.num_vars
        assert len(inputs) == self.num_inputs
        z = list(vars_) + [1] + list(inputs)
        z_mont = F.encode_fr(z, device=device)
        Az = self.A.multiply_vec_device(self.num_cons, z_mont)
        Bz = self.B.multiply_vec_device(self.num_cons, z_mont)
        Cz = self.C.multiply_vec_device(self.num_cons, z_mont)
        diff = fr.sub(fr.mul(Az, Bz), Cz)
        return bool(fr.is_zero(diff).all())

    def evaluate(self, rx: list[int], ry: list[int], device=None) -> tuple[int, int, int]:
        evals = SparseMatPolynomial.multi_evaluate([self.A, self.B, self.C], rx, ry, device)
        return (evals[0], evals[1], evals[2])

    def multiply_vec(self, num_rows: int, num_cols: int, z: list[int], device=None):
        assert num_rows == self.num_cons
        assert len(z) == num_cols
        with Timer("witness_encode"):
            z_mont = F.encode_fr(z, device=device)
        return self.multiply_vec_device(num_rows, z_mont)

    def multiply_vec_device(self, num_rows: int, z_mont):
        """(Az, Bz, Cz) for z given as [num_cols, 8] Montgomery limbs."""
        return (
            DensePolynomial(self.A.multiply_vec_device(num_rows, z_mont)),
            DensePolynomial(self.B.multiply_vec_device(num_rows, z_mont)),
            DensePolynomial(self.C.multiply_vec_device(num_rows, z_mont)),
        )

    def compute_eval_table_sparse_device(self, evals_mont, num_cols: int):
        """(A^T e, B^T e, C^T e) as device tensors (r1cs.rs:148-160)."""
        return (
            self.A.compute_eval_table_sparse_device(evals_mont, num_cols),
            self.B.compute_eval_table_sparse_device(evals_mont, num_cols),
            self.C.compute_eval_table_sparse_device(evals_mont, num_cols),
        )

    def commit(self, gens: "R1CSCommitmentGens", mesh=None):
        """SNARK-mode preprocessing commitment (r1cs.rs:375-400)."""
        from spartan_tpu_torch.core import sparse_mlpoly_full as full

        comm, dense = full.multi_commit([self.A, self.B, self.C], gens.gens, mesh=mesh)
        return (R1CSCommitment(self.num_cons, self.num_vars, self.num_inputs, comm),
                R1CSDecommitment(dense))


class R1CSCommitmentGens:
    """Generators of the SNARK-mode matrix commitment (r1cs.rs:263-343);
    ``pcs`` ('hyrax' or 'kzg') and ``kzg_srs`` pick the derefs commitment."""

    def __init__(self, label: bytes, num_cons: int, num_vars: int,
                 num_nz_entries: int, pcs: str = "hyrax", kzg_srs=None):
        from spartan_tpu_torch.core.sparse_mlpoly_full import SparseMatPolyCommitmentGens

        nx = log_2(num_cons)
        ny = log_2(2 * num_vars)
        # nnz floored at 2 as in SparseMatPolynomial.get_num_nz_entries
        self.gens = SparseMatPolyCommitmentGens(
            label, nx, ny, max(2, next_power_of_two(num_nz_entries)), 3, pcs=pcs,
            kzg_srs=kzg_srs)


def _sparse_commitment_spec(_ctx):
    from spartan_tpu_torch.core.sparse_mlpoly_full import SparseMatPolyCommitment

    return SparseMatPolyCommitment


def _sparse_eval_proof_spec(_ctx):
    from spartan_tpu_torch.core.sparse_mlpoly_full import SparseMatPolyEvalProof

    return SparseMatPolyEvalProof


class R1CSCommitment:
    """Commitment to (A, B, C) (r1cs.rs:345-363)."""

    DESER_SPECS = ["int", "int", "int", _sparse_commitment_spec]

    def __init__(self, num_cons: int, num_vars: int, num_inputs: int, comm):
        self.num_cons = num_cons
        self.num_vars = num_vars
        self.num_inputs = num_inputs
        self.comm = comm

    def append_to_transcript(self, _label: bytes, transcript) -> None:
        transcript.append_u64(b"num_cons", self.num_cons)
        transcript.append_u64(b"num_vars", self.num_vars)
        transcript.append_u64(b"num_inputs", self.num_inputs)
        self.comm.append_to_transcript(b"comm", transcript)

    def serialize_fields(self):
        return [self.num_cons, self.num_vars, self.num_inputs, self.comm]


class R1CSDecommitment:
    """Prover-side dense representation (r1cs.rs:365-370)."""

    def __init__(self, dense):
        self.dense = dense


class R1CSEvalProof:
    """Wraps SparseMatPolyEvalProof (r1cs.rs:416-491)."""

    DESER_SPECS = [_sparse_eval_proof_spec]

    def __init__(self, proof):
        self.proof = proof

    def serialize_fields(self):
        return [self.proof]

    @staticmethod
    def prove(decomm: R1CSDecommitment, rx: list[int], ry: list[int],
              evals: tuple[int, int, int], gens: R1CSCommitmentGens,
              transcript, random_tape, mesh=None) -> "R1CSEvalProof":
        from spartan_tpu_torch.core.sparse_mlpoly_full import SparseMatPolyEvalProof

        with Timer("R1CSEvalProof::prove"):
            return R1CSEvalProof(SparseMatPolyEvalProof.prove(
                decomm.dense, rx, ry, list(evals), gens.gens, transcript, random_tape,
                mesh=mesh))

    def verify(self, comm: R1CSCommitment, rx: list[int], ry: list[int],
               evals: tuple[int, int, int], gens: R1CSCommitmentGens, transcript) -> None:
        self.proof.verify(comm.comm, rx, ry, list(evals), gens.gens, transcript)
