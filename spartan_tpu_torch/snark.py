"""Public proof-system API of the port: Assignment, Instance, NIZK, SNARK.

Counterpart of ``spartan_tpu/snark.py`` (reference src/snark.rs). The
NIZK carries (rx, ry) so its verifier can evaluate A, B, C itself
(snark.rs:183-287); the SNARK instead carries claimed evaluations plus the
sparse-matrix evaluation proof against the preprocessed commitment
(snark.rs:393-529), whose derefs are committed with Hyrax or KZG. The
entry points run on the CUDA card unless the caller passes
``device="cpu"``: ``NIZKGens`` and ``SNARKGens`` place their generators
(and the KZG SRS) on the device, and every prove, encode and verify runs
on the generators' device.
"""

from __future__ import annotations

from dataclasses import dataclass

from spartan_tpu_torch import device as DEV
from spartan_tpu_torch.core.r1cs import (
    R1CSCommitment,
    R1CSCommitmentGens,
    R1CSDecommitment,
    R1CSEvalProof,
    R1CSShape,
)
from spartan_tpu_torch.core.r1csproof import R1CSGens, R1CSProof
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.utils.errors import (
    InvalidIndexError,
    InvalidNumberOfInputsError,
    InvalidScalarError,
    ProofVerifyError,
)
from spartan_tpu_torch.utils.math import log_2, next_power_of_two, pow2
from spartan_tpu_torch.utils.random_tape import RandomTape
from spartan_tpu_torch.utils.timer import Timer
from spartan_tpu_torch.utils.transcript import Transcript


@dataclass
class Assignment:
    """Variable/input assignment as canonical field ints (snark.rs:20-56)."""

    assignment: list[int]

    def __post_init__(self):
        self.assignment = [v % FR_MOD for v in self.assignment]

    def pad(self, length: int) -> "Assignment":
        assert length > len(self.assignment)
        return Assignment(self.assignment + [0] * (length - len(self.assignment)))


VarsAssignment = Assignment
InputsAssignment = Assignment


class Instance:
    """R1CSShape + digest (snark.rs:59-160)."""

    def __init__(self, inst: R1CSShape):
        self.inst = inst
        self.digest = inst.get_digest()

    @staticmethod
    def new(num_cons: int, num_vars: int, num_inputs: int,
            A: list[tuple[int, int, int]], B: list[tuple[int, int, int]],
            C: list[tuple[int, int, int]]) -> "Instance":
        """Pads dims to powers of two with the circom->Spartan column remap
        (columns >= num_vars shift up by the padding, snark.rs:64-128)."""
        num_vars_padded = next_power_of_two(max(num_vars, num_inputs + 1))
        num_cons_padded = next_power_of_two(max(num_cons, 2))

        def convert(tups):
            out = []
            for row, col, val in tups:
                if row >= num_cons:
                    raise InvalidIndexError("row out of range")
                if col >= num_vars + 1 + num_inputs:
                    raise InvalidIndexError("col out of range")
                if not 0 <= val < FR_MOD:
                    # Scalar::from_bytes rejects non-canonical values
                    # (snark.rs:101: InvalidScalar) rather than reducing
                    raise InvalidScalarError(f"value out of field at ({row},{col})")
                adj = col + num_vars_padded - num_vars if col >= num_vars else col
                out.append((row, adj, val))
            return out

        shape = R1CSShape(num_cons_padded, num_vars_padded, num_inputs,
                          convert(A), convert(B), convert(C))
        return Instance(shape)

    @staticmethod
    def from_shape(shape: R1CSShape) -> "Instance":
        return Instance(shape)

    def is_sat(self, vars_: Assignment, inputs: Assignment, device=None) -> bool:
        if len(vars_.assignment) > self.inst.num_vars:
            raise InvalidNumberOfInputsError("too many variables")
        if len(inputs.assignment) != self.inst.num_inputs:
            raise InvalidNumberOfInputsError("wrong number of inputs")
        padded = vars_
        if self.inst.num_vars > len(vars_.assignment):
            padded = vars_.pad(self.inst.num_vars)
        with DEV.use(device):
            return self.inst.is_sat(padded.assignment, inputs.assignment)


def _check_mesh(mesh, gens) -> None:
    if mesh is not None:
        from spartan_tpu_torch.parallel.mesh import check_device

        check_device(mesh, gens.device)


class NIZKGens:
    """Generators of the NIZK, on ``device`` (the CUDA card by default;
    raises if there is none and ``device`` is not given)."""

    def __init__(self, num_cons: int, num_vars: int, num_inputs: int, device=None):
        self.device = DEV.resolve(device)
        num_vars_padded = next_power_of_two(max(num_vars, num_inputs + 1))
        with DEV.use(self.device):
            self.gens_r1cs_sat = R1CSGens(b"gens_r1cs_sat", num_cons, num_vars_padded)


@dataclass
class NIZK:
    r1cs_sat_proof: R1CSProof
    r: tuple[list[int], list[int]]

    PROTOCOL = b"Spartan NIZK proof"

    @staticmethod
    def prove(inst: Instance, vars_: Assignment, input_: Assignment,
              gens: NIZKGens, transcript: Transcript,
              random_tape: RandomTape | None = None, mesh=None) -> "NIZK":
        """``mesh`` (``parallel.make_mesh``, on the generators' device)
        shards the prove over its ranks; every rank must call this with the
        same arguments, and gets the single-device proof."""
        _check_mesh(mesh, gens)
        with Timer("NIZK::prove"):
            tape = random_tape if random_tape is not None else RandomTape(b"proof")
            transcript.append_protocol_name(NIZK.PROTOCOL)
            with Timer("shape_digest_absorb"):
                transcript.append_message(b"R1CSShapeDigest", inst.digest)

            padded = vars_
            if inst.inst.num_vars > len(vars_.assignment):
                padded = vars_.pad(inst.inst.num_vars)

            with DEV.use(gens.device):
                proof, rx, ry = R1CSProof.prove(
                    inst.inst, padded.assignment, input_.assignment,
                    gens.gens_r1cs_sat, transcript, tape, mesh=mesh,
                )
        return NIZK(proof, (rx, ry))

    def verify(self, inst: Instance, input_: Assignment,
               transcript: Transcript, gens: NIZKGens) -> None:
        with Timer("NIZK::verify"):
            transcript.append_protocol_name(NIZK.PROTOCOL)
            with Timer("shape_digest_absorb"):
                transcript.append_message(b"R1CSShapeDigest", inst.digest)

            claimed_rx, claimed_ry = self.r
            with DEV.use(gens.device):
                inst_evals = inst.inst.evaluate(claimed_rx, claimed_ry)

                if len(input_.assignment) != inst.inst.num_inputs:
                    raise ProofVerifyError("wrong number of inputs")
                rx, ry = self.r1cs_sat_proof.verify(
                    inst.inst.num_vars, inst.inst.num_cons, input_.assignment,
                    inst_evals, transcript, gens.gens_r1cs_sat,
                )
        if rx != claimed_rx or ry != claimed_ry:
            raise ProofVerifyError("NIZK: claimed (rx, ry) do not match transcript")


class SNARKGens:
    """Generators of SNARK mode (snark.rs:289-391), on ``device`` (the
    CUDA card by default).

    ``pcs`` picks the derefs commitment ('hyrax' or 'kzg'; default: the
    config's). In KZG mode without ``kzg_srs``, the SRS is loaded from
    ``config.srs_path``, or generated from ``config.srs_seed`` and saved
    there (kzg.rs:104-121).
    """

    def __init__(self, num_cons: int, num_vars: int, num_inputs: int,
                 num_nz_entries: int, pcs: str | None = None, kzg_srs=None,
                 config=None, device=None):
        if config is None:
            from spartan_tpu_torch.config import DEFAULT as config
        if pcs is None:
            pcs = config.pcs
        self.device = DEV.resolve(device)
        num_vars_padded = next_power_of_two(max(num_vars, num_inputs + 1))
        num_cons_padded = next_power_of_two(max(num_cons, 2))
        with DEV.use(self.device):
            if pcs == "kzg" and kzg_srs is None:
                from spartan_tpu_torch.pcs.kzg import KZGSrs

                # the derefs batch of 3 rows -> next pow2 4, x2 for the
                # row/col split: the largest committed vector is
                # 8 * next_pow2(max_nnz), with max_nnz floored at 2 as in
                # R1CSCommitmentGens (the JAX package omits the floor, and
                # its SRS is too short for a one-entry circuit)
                nv = log_2(max(2, next_power_of_two(num_nz_entries))) + 3
                kzg_srs = KZGSrs.load_or_generate(config.srs_path, pow2(nv) + 1,
                                                  config.srs_seed)
            self.gens_r1cs_sat = R1CSGens(b"gens_r1cs_sat", num_cons_padded, num_vars_padded)
            self.gens_r1cs_eval = R1CSCommitmentGens(
                b"gens_r1cs_eval", num_cons_padded, num_vars_padded, num_nz_entries,
                pcs=pcs, kzg_srs=kzg_srs)


@dataclass
class SNARK:
    """Succinct proof: sat proof + claimed evals + eval proof (snark.rs:393-529)."""

    r1cs_sat_proof: R1CSProof
    inst_evals: tuple[int, int, int]
    r1cs_eval_proof: R1CSEvalProof

    PROTOCOL = b"Spartan SNARK proof"

    @staticmethod
    def encode(inst: Instance, gens: SNARKGens,
               mesh=None) -> tuple[R1CSCommitment, R1CSDecommitment]:
        """Preprocessing: commit the R1CS matrices (snark.rs:416-425);
        ``mesh`` shards the row commits."""
        _check_mesh(mesh, gens)
        with Timer("SNARK::encode"), DEV.use(gens.device):
            return inst.inst.commit(gens.gens_r1cs_eval, mesh=mesh)

    @staticmethod
    def prove(inst: Instance, comm: R1CSCommitment, decomm: R1CSDecommitment,
              vars_: Assignment, input_: Assignment, gens: SNARKGens,
              transcript: Transcript, random_tape: RandomTape | None = None,
              mesh=None) -> "SNARK":
        """``mesh`` as in ``NIZK.prove``: the same proof from every rank."""
        _check_mesh(mesh, gens)
        with Timer("SNARK::prove"):
            tape = random_tape if random_tape is not None else RandomTape(b"snark_proof")
            transcript.append_protocol_name(SNARK.PROTOCOL)
            comm.append_to_transcript(b"comm", transcript)

            padded = vars_
            if inst.inst.num_vars > len(vars_.assignment):
                padded = vars_.pad(inst.inst.num_vars)

            with DEV.use(gens.device):
                r1cs_sat_proof, rx, ry = R1CSProof.prove(
                    inst.inst, padded.assignment, input_.assignment,
                    gens.gens_r1cs_sat, transcript, tape, mesh=mesh)
                with Timer("R1CSShape::evaluate"):
                    inst_evals = inst.inst.evaluate(rx, ry)
                # the matrices' device copies are done with; free them before
                # the lookup argument
                for m in (inst.inst.A, inst.inst.B, inst.inst.C):
                    m.release_device()
                r1cs_eval_proof = R1CSEvalProof.prove(
                    decomm, rx, ry, inst_evals, gens.gens_r1cs_eval, transcript, tape,
                    mesh=mesh)
        return SNARK(r1cs_sat_proof, inst_evals, r1cs_eval_proof)

    def verify(self, comm: R1CSCommitment, input_: Assignment,
               transcript: Transcript, gens: SNARKGens) -> None:
        with Timer("SNARK::verify"):
            transcript.append_protocol_name(SNARK.PROTOCOL)
            comm.append_to_transcript(b"comm", transcript)

            if len(input_.assignment) != comm.num_inputs:
                raise ProofVerifyError("wrong number of inputs")
            with DEV.use(gens.device):
                rx, ry = self.r1cs_sat_proof.verify(
                    comm.num_vars, comm.num_cons, input_.assignment,
                    self.inst_evals, transcript, gens.gens_r1cs_sat)
                self.r1cs_eval_proof.verify(
                    comm, rx, ry, self.inst_evals, gens.gens_r1cs_eval, transcript)
