"""Zero-knowledge sumcheck engines of the R1CS proof.

Counterpart of the ZK half of ``spartan_tpu/core/sumcheck.py`` (reference
sumcheck.rs:465-811), in the per-op composition the JAX package runs with
``SPARTAN_TPU_FUSED_ROUND=0``: per round, the round polynomial's
evaluations at {0, 2, 3} are field products of the table halves reduced
with exact sums (the "eval at {0,2,3} trick", sumcheck.rs:89-161), and
the folds bind the top variable elementwise, lo + r * (hi - lo).
Every product, sum and difference is kernel H1; the reductions are exact
plain torch. The host drives the transcript and the tiny per-round algebra,
commits each round polynomial and proves the two claims with a batched
DotProductProof. Tables of at most ``hostpath.HOST_N`` entries finish the
rounds on the host.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

import torch

from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.core import mle
from spartan_tpu_torch.core.commitments import MultiCommitGens, commit, commit_scalar
from spartan_tpu_torch.core.group import GroupElem
from spartan_tpu_torch.core.nizk import DotProductProof
from spartan_tpu_torch.core.unipoly import UniPoly
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.utils.errors import ProofVerifyError
from spartan_tpu_torch.utils.timer import Timer

fr = F.fr


# ---------------------------------------------------------------------------
# per-op round helpers (spartan_tpu/core/sumcheck.py:208-300, 432-517)
# ---------------------------------------------------------------------------

def _halves(T):
    n = T.shape[-2] // 2
    return T[..., :n, :], T[..., n:, :]


def _extrapolate(lo, hi):
    """Table values at points 2 and 3: 2*hi - lo and 3*hi - 2*lo."""
    p2 = fr.sub(fr.add(hi, hi), lo)
    p3 = fr.sub(fr.add(p2, hi), lo)
    return p2, p3


def k_cubic_prod_evals(A, B, C):
    """Round evals (e0, e2, e3) of sum A*B*C; tables [..., N, 8]."""
    aL, aH = _halves(A)
    bL, bH = _halves(B)
    cL, cH = _halves(C)
    a2, a3 = _extrapolate(aL, aH)
    b2, b3 = _extrapolate(bL, bH)
    c2, c3 = _extrapolate(cL, cH)
    e0 = fr.reduce_sum(fr.mul(fr.mul(aL, bL), cL), axis=-2)
    e2 = fr.reduce_sum(fr.mul(fr.mul(a2, b2), c2), axis=-2)
    e3 = fr.reduce_sum(fr.mul(fr.mul(a3, b3), c3), axis=-2)
    return e0, e2, e3


def k_fold_top(T, r):
    """bound_poly_var_top over the second-to-last axis, batched leading dims."""
    lo, hi = _halves(T)
    return fr.add(lo, fr.mul(r, fr.sub(hi, lo)))


def k_cubic_additive_stack(T, A, B, C):
    """Stacked round evals (e0, e2, e3) of sum tau * (Az*Bz - Cz)
    (sumcheck.rs:465-530)."""
    tL, tH = _halves(T)
    aL, aH = _halves(A)
    bL, bH = _halves(B)
    cL, cH = _halves(C)
    t2, t3 = _extrapolate(tL, tH)
    a2, a3 = _extrapolate(aL, aH)
    b2, b3 = _extrapolate(bL, bH)
    c2, c3 = _extrapolate(cL, cH)

    def comb(t, a, b, c):
        return fr.mul(t, fr.sub(fr.mul(a, b), c))

    e0 = fr.reduce_sum(comb(tL, aL, bL, cL), axis=-2)
    e2 = fr.reduce_sum(comb(t2, a2, b2, c2), axis=-2)
    e3 = fr.reduce_sum(comb(t3, a3, b3, c3), axis=-2)
    return torch.stack((e0, e2, e3), dim=0)


def k_step_cubic_additive(T, A, B, C, r):
    """Fold every table by r, then the next round's evals."""
    T, A, B, C = (k_fold_top(t, r) for t in (T, A, B, C))
    return T, A, B, C, k_cubic_additive_stack(T, A, B, C)


def k_folds_cubic_additive(T, A, B, C, r):
    return tuple(k_fold_top(t, r) for t in (T, A, B, C))


def k_quad_stack(A, B):
    """Stacked round evals (e0, e2) of sum A*B (sumcheck.rs:684-699)."""
    aL, aH = _halves(A)
    bL, bH = _halves(B)
    a2 = fr.sub(fr.add(aH, aH), aL)
    b2 = fr.sub(fr.add(bH, bH), bL)
    e0 = fr.reduce_sum(fr.mul(aL, bL), axis=-2)
    e2 = fr.reduce_sum(fr.mul(a2, b2), axis=-2)
    return torch.stack((e0, e2), dim=0)


def k_step_quad(A, B, r):
    A, B = k_fold_top(A, r), k_fold_top(B, r)
    return A, B, k_quad_stack(A, B)


def k_folds_quad(A, B, r):
    return k_fold_top(A, r), k_fold_top(B, r)


# ---------------------------------------------------------------------------
# ZK sumcheck
# ---------------------------------------------------------------------------

@dataclass
class ZKSumcheckInstanceProof:
    comm_polys: list[GroupElem]
    comm_evals: list[GroupElem]
    proofs: list[DotProductProof]

    def verify(self, comm_claim: GroupElem, num_rounds: int, degree_bound: int,
               gens_1: MultiCommitGens, gens_n: MultiCommitGens, transcript):
        """Returns (comm of final eval, r) (sumcheck.rs:366-457)."""
        if len(self.comm_polys) != num_rounds or len(self.proofs) != num_rounds:
            raise ProofVerifyError("wrong number of rounds")
        comm_claim_per_round = comm_claim
        r: list[int] = []
        for i in range(num_rounds):
            comm_poly = self.comm_polys[i]
            comm_poly.append_to_transcript(b"comm_poly", transcript)
            r_i = transcript.challenge_scalar(b"challenge_nextround")
            comm_claim_per_round.append_to_transcript(b"comm_claim_per_round", transcript)
            self.comm_evals[i].append_to_transcript(b"comm_eval", transcript)
            w = transcript.challenge_vector(b"combine_two_claims_to_one", 2)
            comm_target = comm_claim_per_round.mul(w[0]).add(self.comm_evals[i].mul(w[1]))

            a_sc = [1] * (degree_bound + 1)
            a_sc[0] = 2
            a_eval = [1] * (degree_bound + 1)
            for j in range(1, degree_bound + 1):
                a_eval[j] = a_eval[j - 1] * r_i % FR_MOD
            a = [(w[0] * a_sc[j] + w[1] * a_eval[j]) % FR_MOD for j in range(degree_bound + 1)]

            self.proofs[i].verify(gens_1, gens_n, transcript, a, comm_poly, comm_target)
            comm_claim_per_round = self.comm_evals[i]
            r.append(r_i)
        return self.comm_evals[-1], r

    @staticmethod
    def _round_tail(poly: UniPoly, r_j: int, claim_per_round: int,
                    comm_claim_per_round: GroupElem, blind_poly_j: int,
                    blind_eval_j: int, blind_sc: int,
                    gens_1, gens_n, transcript, random_tape):
        """Post-fold half of a ZK round: batch the two claims into one
        DotProductProof (sumcheck.rs:556-634)."""
        eval_ = poly.evaluate(r_j)
        comm_eval = commit_scalar(eval_, blind_eval_j, gens_1)
        comm_claim_per_round.append_to_transcript(b"comm_claim_per_round", transcript)
        comm_eval.append_to_transcript(b"comm_eval", transcript)
        w = transcript.challenge_vector(b"combine_two_claims_to_one", 2)
        target = (w[0] * claim_per_round + w[1] * eval_) % FR_MOD
        blind = (w[0] * blind_sc + w[1] * blind_eval_j) % FR_MOD

        deg = poly.degree()
        a_sc = [1] * (deg + 1)
        a_sc[0] = 2
        a_eval = [1] * (deg + 1)
        for k in range(1, deg + 1):
            a_eval[k] = a_eval[k - 1] * r_j % FR_MOD
        a = [(w[0] * a_sc[k] + w[1] * a_eval[k]) % FR_MOD for k in range(deg + 1)]

        proof, _, _ = DotProductProof.prove(
            gens_1, gens_n, transcript, random_tape,
            poly.as_vec(), blind_poly_j, a, target, blind,
        )
        return proof, eval_, comm_eval

    @staticmethod
    def _rounds(kind: str, claim: int, blind_claim: int, num_rounds: int, tables,
                gens_1, gens_n, transcript, random_tape):
        """Shared round loop of the cubic-additive and quad sumchecks."""
        if kind == "cubic":
            host_evals, stack, step, folds = (HP.cubic_additive_evals, k_cubic_additive_stack,
                                              k_step_cubic_additive, k_folds_cubic_additive)
        else:
            host_evals, stack, step, folds = (HP.quad_evals, k_quad_stack,
                                              k_step_quad, k_folds_quad)
        blinds_poly = random_tape.random_vector(b"blinds_poly", num_rounds)
        blinds_evals = random_tape.random_vector(b"blinds_evals", num_rounds)
        claim_per_round = claim % FR_MOD
        comm_claim_per_round = commit_scalar(claim_per_round, blind_claim, gens_1)

        r: list[int] = []
        comm_polys: list[GroupElem] = []
        comm_evals: list[GroupElem] = []
        proofs: list[DotProductProof] = []

        host = None      # host-int tables for the small-size tail
        pending = None   # device evals for the current round (fused step)
        cur_n = tables[0].len
        dev = tables[0].Z.device
        for j in range(num_rounds):
            _t = _time.perf_counter()
            if host is None and cur_n <= HP.HOST_N:
                host = mle.decode_tables([p.Z for p in tables])
            if host is not None:
                v = host_evals(*host)
            else:
                if pending is None:
                    pending = stack(*(p.Z for p in tables))
                v = F.decode_fr(pending)
            Timer.acc(f"zk_{kind}/evals", _time.perf_counter() - _t)
            _t = _time.perf_counter()
            poly = UniPoly.from_evals([v[0], (claim_per_round - v[0]) % FR_MOD, *v[1:]])
            comm_poly = commit(poly.as_vec(), blinds_poly[j], gens_n)
            comm_poly.append_to_transcript(b"comm_poly", transcript)
            comm_polys.append(comm_poly)

            r_j = transcript.challenge_scalar(b"challenge_nextround")
            Timer.acc(f"zk_{kind}/commit_poly", _time.perf_counter() - _t)
            _t = _time.perf_counter()
            if host is not None:
                host = [HP.fold_top(t, r_j) for t in host]
            else:
                r_dev = mle.encode_scalar(r_j, dev)
                if cur_n // 2 <= HP.HOST_N:
                    folded = folds(*(p.Z for p in tables), r_dev)
                    pending = None
                else:
                    *folded, pending = step(*(p.Z for p in tables), r_dev)
                for p, z in zip(tables, folded):
                    p.rebind(z)
            cur_n //= 2
            Timer.acc(f"zk_{kind}/fold", _time.perf_counter() - _t)

            _t = _time.perf_counter()
            blind_sc = blind_claim if j == 0 else blinds_evals[j - 1]
            proof, eval_, comm_eval = ZKSumcheckInstanceProof._round_tail(
                poly, r_j, claim_per_round, comm_claim_per_round,
                blinds_poly[j], blinds_evals[j], blind_sc,
                gens_1, gens_n, transcript, random_tape,
            )
            Timer.acc(f"zk_{kind}/round_tail", _time.perf_counter() - _t)
            proofs.append(proof)
            claim_per_round = eval_
            comm_claim_per_round = comm_eval
            r.append(r_j)
            comm_evals.append(comm_eval)

        if host is not None:
            claims = [t[0] for t in host]
        else:
            claims = [p.first() for p in tables]
        return (
            ZKSumcheckInstanceProof(comm_polys, comm_evals, proofs),
            r, claims, blinds_evals[num_rounds - 1],
        )

    @staticmethod
    def prove_cubic_with_additive_term(claim: int, blind_claim: int, num_rounds: int,
                                       poly_tau, poly_Az, poly_Bz, poly_Cz,
                                       gens_1, gens_n, transcript, random_tape):
        """ZK sumcheck of sum tau*(Az*Bz - Cz) (sumcheck.rs:465-649)."""
        return ZKSumcheckInstanceProof._rounds(
            "cubic", claim, blind_claim, num_rounds,
            [poly_tau, poly_Az, poly_Bz, poly_Cz], gens_1, gens_n, transcript, random_tape)

    @staticmethod
    def prove_quad(claim: int, blind_claim: int, num_rounds: int,
                   poly_z, poly_ABC, gens_1, gens_n, transcript, random_tape):
        """ZK sumcheck of sum z*ABC (sumcheck.rs:657-811)."""
        return ZKSumcheckInstanceProof._rounds(
            "quad", claim, blind_claim, num_rounds,
            [poly_z, poly_ABC], gens_1, gens_n, transcript, random_tape)
