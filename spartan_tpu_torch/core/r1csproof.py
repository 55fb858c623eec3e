"""Two-phase R1CS satisfiability proof — the heart of Spartan.

Counterpart of ``spartan_tpu/core/r1csproof.py`` (reference
src/r1csproof.rs:185-620):
phase-1 ZK cubic sumcheck over tau*(Az*Bz - Cz), claim PoKs + product
proof + equality link, phase-2 ZK quad sumcheck over z * RLC(A,B,C)^T eq(rx),
then a Hyrax opening of the witness MLE at ry[1:]. The verifier mirrors the
prover with commitment-homomorphic checks, including the input-MLE
correction term (1-ry0)*Z(ry) + ry0*Input(ry).

Transcript labels and ordering match the reference byte-for-byte.
"""

from __future__ import annotations

from dataclasses import dataclass

from spartan_tpu_torch.core import mle
from spartan_tpu_torch.core.commitments import MultiCommitGens, commit_scalar
from spartan_tpu_torch.core.group import GroupElem
from spartan_tpu_torch.core.mle import DensePolynomial, EqPolynomial
from spartan_tpu_torch.core.nizk import EqualityProof, KnowledgeProof, ProductProof
from spartan_tpu_torch.core.r1cs import R1CSShape
from spartan_tpu_torch.core.sumcheck import ZKSumcheckInstanceProof
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.pcs.hyrax import (
    PolyCommitment,
    PolyCommitmentGens,
    PolyEvalProof,
    commit_poly,
)
from spartan_tpu_torch.utils.math import log_2

fr = F.fr


def k_rlc3(a, b, c, ra, rb, rc):
    """ra*a + rb*b + rc*c elementwise over [N, 8] tables (scalars [8])."""
    return fr.add(fr.add(fr.mul(ra, a), fr.mul(rb, b)), fr.mul(rc, c))


class R1CSSumcheckGens:
    """gens_1/gens_3/gens_4 bundle (r1csproof.rs:147-167)."""

    def __init__(self, label: bytes, gens_1: MultiCommitGens):
        self.gens_1 = gens_1
        self.gens_3 = MultiCommitGens(3, label)
        self.gens_4 = MultiCommitGens(4, label)


class R1CSGens:
    def __init__(self, label: bytes, _num_cons: int, num_vars: int):
        num_poly_vars = log_2(num_vars)
        self.gens_pc = PolyCommitmentGens(num_poly_vars, label)
        self.gens_sc = R1CSSumcheckGens(label, self.gens_pc.gens.gens_1)
        self.device = self.gens_pc.gens.gens_n.device


@dataclass
class R1CSProof:
    comm_vars: PolyCommitment
    sc_proof_phase1: ZKSumcheckInstanceProof
    claims_phase2: tuple  # (comm_Az, comm_Bz, comm_Cz, comm_prod_Az_Bz)
    pok_claims_phase2: tuple  # (KnowledgeProof for Cz, ProductProof)
    proof_eq_sc_phase1: EqualityProof
    sc_proof_phase2: ZKSumcheckInstanceProof
    comm_vars_at_ry: GroupElem
    proof_eval_vars_at_ry: PolyEvalProof
    proof_eq_sc_phase2: EqualityProof

    SCHEMA = {
        "claims_phase2": ("tuple", GroupElem, GroupElem, GroupElem, GroupElem),
        "pok_claims_phase2": ("tuple", KnowledgeProof, ProductProof),
    }

    PROTOCOL = b"R1CS proof"

    @staticmethod
    def prove(inst: R1CSShape, vars_: list[int], input_: list[int],
              gens: R1CSGens, transcript, random_tape, mesh=None):
        """Returns (proof, rx, ry) (r1csproof.rs:241-459). Device tensors
        follow the generators' device. ``mesh`` shards the witness commit,
        both sumcheck phases' tables and the witness opening."""
        from spartan_tpu_torch.utils.timer import Timer

        timer_prove = Timer("R1CSProof::prove")
        transcript.append_protocol_name(R1CSProof.PROTOCOL)
        assert len(input_) < len(vars_)
        transcript.append_scalars(b"input", input_)

        dev = gens.device
        timer_commit = Timer("polycommit")
        # the witness's one host encode; z = (vars, 1, inputs, 0...) is
        # assembled from it on the device for each phase
        with Timer("witness_encode"):
            poly_vars = DensePolynomial.from_ints(vars_, device=dev)
            inputs_mont = F.encode_fr(input_, device=dev)

        def z_device():
            with Timer("witness_encode"):
                return inst.build_z_device(poly_vars.Z, inputs_mont)

        comm_vars, blinds_vars = commit_poly(poly_vars, gens.gens_pc, random_tape, mesh=mesh)
        comm_vars.append_to_transcript(b"poly_commitment", transcript)
        timer_commit.stop()

        timer_sc1 = Timer("prove_sc_phase_one")
        num_cols = 2 * inst.num_vars
        num_rounds_x = log_2(inst.num_cons)
        num_rounds_y = log_2(num_cols)
        tau = transcript.challenge_vector(b"challenge_tau", num_rounds_x)

        with Timer("sc1_tau_eq_table"):
            poly_tau = DensePolynomial(EqPolynomial(tau).evals_device(dev))
        with Timer("sc1_spmv_AzBzCz"):
            poly_Az, poly_Bz, poly_Cz = inst.multiply_vec_device(inst.num_cons, z_device())

        # PHASE 1: ZK cubic sumcheck of sum_x tau(x) * (Az(x)Bz(x) - Cz(x))
        with Timer("sc1_zk_sumcheck"):
            (sc_proof_phase1, rx, claims_phase1, blind_claim_postsc1) = \
                ZKSumcheckInstanceProof.prove_cubic_with_additive_term(
                    0, 0, num_rounds_x, poly_tau, poly_Az, poly_Bz, poly_Cz,
                    gens.gens_sc.gens_1, gens.gens_sc.gens_4, transcript,
                    random_tape, mesh=mesh,
                )
        tau_claim, Az_claim, Bz_claim, Cz_claim = claims_phase1
        timer_sc1.stop()

        Az_blind = random_tape.random_scalar(b"Az_blind")
        Bz_blind = random_tape.random_scalar(b"Bz_blind")
        Cz_blind = random_tape.random_scalar(b"Cz_blind")
        prod_Az_Bz_blind = random_tape.random_scalar(b"prod_Az_Bz_blind")

        pok_Cz_claim, comm_Cz_claim = KnowledgeProof.prove(
            gens.gens_sc.gens_1, transcript, random_tape, Cz_claim, Cz_blind)

        prod = Az_claim * Bz_claim % FR_MOD
        proof_prod, comm_Az_claim, comm_Bz_claim, comm_prod_Az_Bz_claims = \
            ProductProof.prove(gens.gens_sc.gens_1, transcript, random_tape,
                               Az_claim, Az_blind, Bz_claim, Bz_blind,
                               prod, prod_Az_Bz_blind)

        comm_Az_claim.append_to_transcript(b"comm_Az_claim", transcript)
        comm_Bz_claim.append_to_transcript(b"comm_Bz_claim", transcript)
        comm_Cz_claim.append_to_transcript(b"comm_Cz_claim", transcript)
        comm_prod_Az_Bz_claims.append_to_transcript(b"comm_prod_Az_Bz_claims", transcript)

        # final step of sumcheck #1: link (AzBz - Cz)*tau(rx) to the sumcheck claim
        blind_expected_claim_postsc1 = tau_claim * (prod_Az_Bz_blind - Cz_blind) % FR_MOD
        claim_post_phase1 = (Az_claim * Bz_claim - Cz_claim) * tau_claim % FR_MOD
        proof_eq_sc_phase1, _C1, _C2 = EqualityProof.prove(
            gens.gens_sc.gens_1, transcript, random_tape,
            claim_post_phase1, blind_expected_claim_postsc1,
            claim_post_phase1, blind_claim_postsc1,
        )

        # PHASE 2 setup: joint claim via random coefficients
        r_A = transcript.challenge_scalar(b"challenge_Az")
        r_B = transcript.challenge_scalar(b"challenge_Bz")
        r_C = transcript.challenge_scalar(b"challenge_Cz")
        claim_phase2 = (r_A * Az_claim + r_B * Bz_claim + r_C * Cz_claim) % FR_MOD
        blind_claim_phase2 = (r_A * Az_blind + r_B * Bz_blind + r_C * Cz_blind) % FR_MOD

        with Timer("sc2_eval_tables"):
            evals_rx = EqPolynomial(rx).evals_device(dev)
            evals_A, evals_B, evals_C = inst.compute_eval_table_sparse_device(
                evals_rx, num_cols)
            evals_ABC = k_rlc3(evals_A, evals_B, evals_C,
                               mle.encode_scalar(r_A, dev), mle.encode_scalar(r_B, dev),
                               mle.encode_scalar(r_C, dev))

        timer_sc2 = Timer("prove_sc_phase_two")
        with Timer("sc2_encode_z"):
            poly_z = DensePolynomial(z_device())
        poly_ABC = DensePolynomial(evals_ABC)
        (sc_proof_phase2, ry, claims_phase2, blind_claim_postsc2) = \
            ZKSumcheckInstanceProof.prove_quad(
                claim_phase2, blind_claim_phase2, num_rounds_y,
                poly_z, poly_ABC,
                gens.gens_sc.gens_1, gens.gens_sc.gens_3, transcript, random_tape,
                mesh=mesh,
            )
        timer_sc2.stop()

        # witness opening at ry[1:]
        timer_polyeval = Timer("polyeval")
        eval_vars_at_ry = poly_vars.evaluate(ry[1:])
        blind_eval = random_tape.random_scalar(b"blind_eval")
        proof_eval_vars_at_ry, comm_vars_at_ry = PolyEvalProof.prove(
            poly_vars, blinds_vars, ry[1:], eval_vars_at_ry, blind_eval,
            gens.gens_pc, transcript, random_tape, mesh=mesh,
        )
        timer_polyeval.stop()

        # final step of sumcheck #2
        blind_eval_Z_at_ry = (1 - ry[0]) * blind_eval % FR_MOD
        blind_expected_claim_postsc2 = claims_phase2[1] * blind_eval_Z_at_ry % FR_MOD
        claim_post_phase2 = claims_phase2[0] * claims_phase2[1] % FR_MOD
        proof_eq_sc_phase2, _C1, _C2 = EqualityProof.prove(
            gens.gens_pc.gens.gens_1, transcript, random_tape,
            claim_post_phase2, blind_expected_claim_postsc2,
            claim_post_phase2, blind_claim_postsc2,
        )

        timer_prove.stop()
        proof = R1CSProof(
            comm_vars=comm_vars,
            sc_proof_phase1=sc_proof_phase1,
            claims_phase2=(comm_Az_claim, comm_Bz_claim, comm_Cz_claim, comm_prod_Az_Bz_claims),
            pok_claims_phase2=(pok_Cz_claim, proof_prod),
            proof_eq_sc_phase1=proof_eq_sc_phase1,
            sc_proof_phase2=sc_proof_phase2,
            comm_vars_at_ry=comm_vars_at_ry,
            proof_eval_vars_at_ry=proof_eval_vars_at_ry,
            proof_eq_sc_phase2=proof_eq_sc_phase2,
        )
        return proof, rx, ry

    def verify(self, num_vars: int, num_cons: int, input_: list[int],
               evals: tuple[int, int, int], transcript, gens: R1CSGens):
        """Returns (rx, ry) on success (r1csproof.rs:463-619)."""
        transcript.append_protocol_name(R1CSProof.PROTOCOL)
        transcript.append_scalars(b"input", input_)
        self.comm_vars.append_to_transcript(b"poly_commitment", transcript)

        num_rounds_x = log_2(num_cons)
        num_rounds_y = log_2(2 * num_vars)
        tau = transcript.challenge_vector(b"challenge_tau", num_rounds_x)

        from spartan_tpu_torch.utils.timer import Timer

        # phase-1 sumcheck: claim is a commitment to zero with zero blind
        claim_phase1 = commit_scalar(0, 0, gens.gens_sc.gens_1)
        with Timer("v_sc_phase1"):
            comm_claim_post_phase1, rx = self.sc_proof_phase1.verify(
                claim_phase1, num_rounds_x, 3,
                gens.gens_sc.gens_1, gens.gens_sc.gens_4, transcript,
            )

        comm_Az_claim, comm_Bz_claim, comm_Cz_claim, comm_prod_Az_Bz_claims = self.claims_phase2
        pok_Cz_claim, proof_prod = self.pok_claims_phase2

        pok_Cz_claim.verify(gens.gens_sc.gens_1, transcript, comm_Cz_claim)
        proof_prod.verify(gens.gens_sc.gens_1, transcript,
                          comm_Az_claim, comm_Bz_claim, comm_prod_Az_Bz_claims)

        comm_Az_claim.append_to_transcript(b"comm_Az_claim", transcript)
        comm_Bz_claim.append_to_transcript(b"comm_Bz_claim", transcript)
        comm_Cz_claim.append_to_transcript(b"comm_Cz_claim", transcript)
        comm_prod_Az_Bz_claims.append_to_transcript(b"comm_prod_Az_Bz_claims", transcript)

        taus_bound_rx = EqPolynomial(tau).evaluate(rx)
        expected_claim_post_phase1 = (
            comm_prod_Az_Bz_claims.add(comm_Cz_claim.neg()).mul(taus_bound_rx)
        )
        self.proof_eq_sc_phase1.verify(
            gens.gens_sc.gens_1, transcript,
            expected_claim_post_phase1, comm_claim_post_phase1,
        )

        r_A = transcript.challenge_scalar(b"challenge_Az")
        r_B = transcript.challenge_scalar(b"challenge_Bz")
        r_C = transcript.challenge_scalar(b"challenge_Cz")
        comm_claim_phase2 = (
            comm_Az_claim.mul(r_A).add(comm_Bz_claim.mul(r_B)).add(comm_Cz_claim.mul(r_C))
        )

        with Timer("v_sc_phase2"):
            comm_claim_post_phase2, ry = self.sc_proof_phase2.verify(
                comm_claim_phase2, num_rounds_y, 2,
                gens.gens_sc.gens_1, gens.gens_sc.gens_3, transcript,
            )

        # witness opening against the initial commitment
        self.proof_eval_vars_at_ry.verify(
            gens.gens_pc, transcript, ry[1:], self.comm_vars_at_ry, self.comm_vars)

        # input MLE at ry[1:]: entries (0 -> 1, i+1 -> input_i) over log(n) vars
        poly_input_eval = _input_mle_eval(input_, ry[1:])

        comm_eval_Z_at_ry = (
            self.comm_vars_at_ry.mul((1 - ry[0]) % FR_MOD)
            .add(commit_scalar(poly_input_eval, 0, gens.gens_pc.gens.gens_1).mul(ry[0]))
        )

        eval_A_r, eval_B_r, eval_C_r = evals
        scalar = (r_A * eval_A_r + r_B * eval_B_r + r_C * eval_C_r) % FR_MOD
        expected_claim_post_phase2 = comm_eval_Z_at_ry.mul(scalar)
        self.proof_eq_sc_phase2.verify(
            gens.gens_sc.gens_1, transcript,
            expected_claim_post_phase2, comm_claim_post_phase2,
        )
        return rx, ry


def _input_mle_eval(input_: list[int], ry_rest: list[int]) -> int:
    """Evaluate the (1, inputs, 0...) MLE at ry_rest (r1csproof.rs:580-594).

    Host-exact: eq(ry_rest, bits(col)) per sparse entry; num_inputs+1 terms.
    """
    ell = len(ry_rest)

    def eq_at(col: int) -> int:
        acc = 1
        for j in range(ell):
            bit = (col >> (ell - 1 - j)) & 1
            term = ry_rest[j] if bit else (1 - ry_rest[j])
            acc = acc * term % FR_MOD
        return acc

    total = eq_at(0)  # constant-1 entry at column 0
    for i, v in enumerate(input_):
        total = (total + v * eq_at(i + 1)) % FR_MOD
    return total
