"""Sumcheck engines: the batched product sumcheck and the ZK ones.

Counterpart of ``spartan_tpu/core/sumcheck.py`` (reference sumcheck.rs).
Per round, the round polynomial's evaluations at {0, 2, 3}
(the "eval at {0,2,3} trick", sumcheck.rs:89-161) and the folds that bind
the top variable, lo + r * (hi - lo), are the fused round kernels of
``ops/sumcheck_kernels.py``: a round folds every table by the previous
challenge and computes the next round's evaluations in one launch (S2 for
the product layers, S3 for ZK phase 1, S4 for ZK phase 2; S1 folds alone
where the next round runs elsewhere). Tables stay in natural order.

The batched product sumcheck has one driver on every device: it hands its
rounds to ``core/sumcheck_fused.py``, where the challenges are squeezed
on the device (T1 above ``SMALL_BUCKET_N`` entries, the whole tail in one
T2 launch) and the host replays the transcript once at the end; on a CPU
tensor the kernels' plain versions run the same steps. The ZK sumchecks
drive the host transcript round by round: the host reads each round's
evaluations, commits each round polynomial and proves the two claims with
a batched DotProductProof; there, tables of at most ``hostpath.HOST_N``
entries finish their rounds on the host in Python ints.

With ``mesh`` (``parallel/``), large tables are strided-sharded over the
ranks (``_MeshTables``, ``_BatchedMeshTables``): each round's evaluations
are the ranks' partials on the same kernels joined by one exact psum, and
the host transcript is driven round by round on every rank. The ZK tables
are gathered once they shrink to ``HOST_N`` entries (or below twice the
rank count), as in the JAX package; a batched product sumcheck leaves the
mesh at the larger of ``HOST_N`` and ``sumcheck_fused.SMALL_BUCKET_N``
entries and hands the remaining rounds to the fused driver. The proof
bytes are the single-device ones either way.
"""

from __future__ import annotations

from dataclasses import dataclass

from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.core import mle
from spartan_tpu_torch.core import sumcheck_fused as SF
from spartan_tpu_torch.core.commitments import MultiCommitGens, commit, commit_scalar
from spartan_tpu_torch.core.group import GroupElem
from spartan_tpu_torch.core.nizk import DotProductProof
from spartan_tpu_torch.core.unipoly import CompressedUniPoly, UniPoly
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import sumcheck_kernels as SK
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.utils.errors import ProofVerifyError
from spartan_tpu_torch.utils.timer import Timer


# ---------------------------------------------------------------------------
# non-ZK sumcheck
# ---------------------------------------------------------------------------

@dataclass
class SumcheckInstanceProof:
    compressed_polys: list[CompressedUniPoly]

    def verify(self, claim: int, num_rounds: int, degree_bound: int, transcript):
        """Returns (final claim e, challenge vector r) (sumcheck.rs:35-86)."""
        e = claim % FR_MOD
        r: list[int] = []
        if len(self.compressed_polys) != num_rounds:
            raise ProofVerifyError("wrong number of rounds")
        for i, cp in enumerate(self.compressed_polys):
            poly = cp.decompress(e)
            if poly.degree() != degree_bound:
                raise ProofVerifyError(f"degree mismatch at round {i}")
            if (poly.eval_at_zero() + poly.eval_at_one()) % FR_MOD != e:
                raise ProofVerifyError(f"sum check failed at round {i}")
            poly.append_to_transcript(b"poly", transcript)
            r_i = transcript.challenge_scalar(b"challenge_nextround")
            r.append(r_i)
            e = poly.evaluate(r_i)
        return e, r

    @staticmethod
    def prove_cubic(claim: int, num_rounds: int, poly_A, poly_B, poly_C, transcript):
        """Product comb A*B*C (sumcheck.rs:89-161): the batched sumcheck
        with one instance and coefficient 1, which sends the same round
        polynomials. The tables are consumed. Returns (proof, r, [A(r),
        B(r), C(r)])."""
        proof, r, (fa, fb, fc), _ = SumcheckInstanceProof.prove_cubic_batched(
            claim, num_rounds, ([poly_A], [poly_B], poly_C), ([], [], []), [1], transcript)
        return proof, r, [fa[0], fb[0], fc]

    @staticmethod
    def prove_cubic_batched(claim: int, num_rounds: int, poly_vec_par, poly_vec_seq,
                            coeffs: list[int], transcript, mesh=None):
        """Batched product sumcheck (sumcheck.rs:165-330).

        poly_vec_par: (A_list, B_list, C_shared) DensePolynomials; the
        "par" instances share C (the eq table). poly_vec_seq: (A_list,
        B_list, C_list) with per-instance C. All tables have equal length.
        Every round runs in the fused driver
        (``SF.prove_cubic_batched_fused``). With ``mesh`` the rounds above
        the mesh's exit size run sharded first (the JAX package checks the
        mesh before the fused tail too), each round's evaluations read by
        the host, which squeezes the challenge; the gathered tables then go
        to the fused driver. Every input table is consumed (its ``Z`` is
        dropped once folded).
        Returns (proof, r, (A_par(r), B_par(r), C(r)), (A_seq(r),
        B_seq(r), C_seq(r))).
        """
        A_par, B_par, C_par = poly_vec_par
        A_seq, B_seq, C_seq = poly_vec_seq
        nP, nS = len(A_par), len(A_seq)
        I = nP + nS

        TA = [p.Z for p in A_par] + [p.Z for p in A_seq]
        TB = [p.Z for p in B_par] + [p.Z for p in B_seq]
        TC = [p.Z for p in C_seq]
        Cp = C_par.Z
        # consumed inputs: from here the tables live only in TA/TB/TC/Cp
        for p in (*A_par, *B_par, C_par, *A_seq, *B_seq, *C_seq):
            p.Z = None

        e = claim % FR_MOD
        r: list[int] = []
        polys: list[CompressedUniPoly] = []
        # the mesh hands over where T2 takes the tail
        leave = max(HP.HOST_N, SF.SMALL_BUCKET_N)
        n0 = Cp.shape[0]
        if mesh is not None and mesh.size > 1 and n0 > leave and \
                n0 >= 2 * mesh.size and n0 % (2 * mesh.size) == 0:
            dev = Cp.device
            mesh_t = _BatchedMeshTables(mesh, TA, TB, TC, Cp, nP, leave)
            TA = TB = TC = Cp = None
            pending = mesh_t.evals()
            while pending is not None:
                vals = F.decode_fr(pending)
                c0, c2, c3 = (sum(vals[3 * i + k] * coeffs[i] for i in range(I)) % FR_MOD
                              for k in range(3))
                poly = UniPoly.from_evals([c0, (e - c0) % FR_MOD, c2, c3])
                poly.append_to_transcript(b"poly", transcript)
                r_j = transcript.challenge_scalar(b"challenge_nextround")
                r_dev = mle.encode_scalar(r_j, dev)
                if mesh_t.can_step():
                    pending = mesh_t.step(r_dev)
                else:
                    TA, TB, TC, Cp = mesh_t.fold_gather(r_dev)
                    pending = None
                r.append(r_j)
                e = poly.evaluate(r_j)
                polys.append(poly.compress())

        if num_rounds > len(r):
            polys_f, r_f, claims_prod, claims_dotp = SF.prove_cubic_batched_fused(
                e, num_rounds - len(r), TA, TB, TC, Cp, nP, coeffs, transcript)
            return SumcheckInstanceProof(polys + polys_f), r + r_f, claims_prod, claims_dotp

        # no rounds: the one-entry tables are the claims
        finals = F.decode_fr(mle.first_rows(TA + TB + [Cp] + TC))
        finals_A, finals_B = finals[:I], finals[I:2 * I]
        claims_prod = (finals_A[:nP], finals_B[:nP], finals[2 * I])
        claims_dotp = (finals_A[nP:], finals_B[nP:], finals[2 * I + 1:])
        return SumcheckInstanceProof(polys), r, claims_prod, claims_dotp


# ---------------------------------------------------------------------------
# sharded tables (sequence-parallel sumcheck over a mesh)
# ---------------------------------------------------------------------------

class _MeshTables:
    """The ZK sumchecks' tables, strided-sharded over the ranks.

    The strided layout keeps the top-variable folds on each rank; once a
    table folds to ``HOST_N`` entries or below twice the rank count, the
    tables are gathered back into the polynomials and the rounds go on
    unsharded. Each table's full copy is dropped once its shard is taken.
    """

    def __init__(self, mesh, tables, kind: str):
        from spartan_tpu_torch.parallel import sumcheck_sharded as SS
        from spartan_tpu_torch.parallel.mesh import shard_strided

        self.mesh, self.D = mesh, mesh.size
        if kind == "cubic":
            self._evals, self._step = SS.make_cubic_evals, SS.make_cubic_step
        else:
            self._evals, self._step = SS.make_quad_evals, SS.make_quad_step
        self.n = tables[0].len
        assert self.n >= 2 * self.D and self.n % (2 * self.D) == 0
        self.polys = tables   # rebound on the gather
        self.sharded = []
        for p in tables:
            self.sharded.append(shard_strided(mesh, p.Z))
            p.Z = None

    def can_step(self) -> bool:
        """Whether the folded tables still span the mesh above ``HOST_N``
        (the fused step stays valid); otherwise ``fold_gather`` leaves."""
        return self.n // 2 >= 2 * self.D and self.n // 2 > HP.HOST_N

    def evals(self):
        return self._evals(self.mesh, *self.sharded)

    def step(self, r_dev):
        """Fold by r, then the next round's evaluations: one launch a rank."""
        *self.sharded, ev = self._step(self.mesh, *self.sharded, r_dev)
        self.n //= 2
        return ev

    def fold_gather(self, r_dev) -> None:
        """Fold once more (the step is no longer valid), then gather the
        natural-order tables back into the polynomials on every rank."""
        from spartan_tpu_torch.parallel.mesh import gather_unstride
        from spartan_tpu_torch.parallel.sumcheck_sharded import make_fold

        for p, t in zip(self.polys, make_fold(self.mesh, self.sharded, r_dev)):
            p.rebind(gather_unstride(self.mesh, t))
        self.sharded = None


class _BatchedMeshTables:
    """Strided-sharded tables of a batched product sumcheck (the product
    trees' layers, the prove's largest sumchecks), as ``_MeshTables``; the
    mesh is left once the folded tables reach ``leave`` entries."""

    def __init__(self, mesh, TA, TB, TC, Cp, nP: int, leave: int):
        from spartan_tpu_torch.parallel.mesh import shard_strided

        self.mesh, self.D, self.nP = mesh, mesh.size, nP
        self.n = Cp.shape[0]
        assert self.n >= 2 * self.D and self.n % (2 * self.D) == 0
        self.leave = leave

        def shard(tables):
            # take each shard, then drop the caller's full table
            out = []
            for k in range(len(tables)):
                out.append(shard_strided(mesh, tables[k]))
                tables[k] = None
            return out

        self.TA, self.TB, self.TC = shard(TA), shard(TB), shard(TC)
        self.Cp = shard_strided(mesh, Cp)

    def can_step(self) -> bool:
        return self.n // 2 >= 2 * self.D and self.n // 2 > self.leave

    def evals(self):
        from spartan_tpu_torch.parallel.sumcheck_sharded import make_batched_evals

        return make_batched_evals(self.mesh, self.nP, self.TA, self.TB, self.TC, self.Cp)

    def step(self, r_dev):
        """Fold every table by r, then the next round's evaluations."""
        from spartan_tpu_torch.parallel.sumcheck_sharded import make_batched_step

        self.TA, self.TB, self.TC, self.Cp, ev = make_batched_step(
            self.mesh, self.nP, self.TA, self.TB, self.TC, self.Cp, r_dev)
        self.n //= 2
        return ev

    def fold_gather(self, r_dev):
        """Fold once more, then the natural-order tables on every rank."""
        from spartan_tpu_torch.parallel.mesh import gather_unstride
        from spartan_tpu_torch.parallel.sumcheck_sharded import make_batched_fold

        TA, TB, TC, Cp = make_batched_fold(self.mesh, self.TA, self.TB, self.TC, self.Cp,
                                           r_dev)
        self.TA = self.TB = self.TC = self.Cp = None

        def g(ts):
            return [gather_unstride(self.mesh, t) for t in ts]

        return g(TA), g(TB), g(TC), gather_unstride(self.mesh, Cp)


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
                gens_1, gens_n, transcript, random_tape, mesh=None):
        """Shared round loop of the cubic-additive and quad sumchecks; with
        ``mesh`` the tables are sharded until they shrink to ``HOST_N``."""
        if kind == "cubic":
            host_evals, evals, step = (HP.cubic_additive_evals, SK.additive_evals,
                                       SK.additive_step)
        else:
            host_evals, evals, step = HP.quad_evals, SK.quad_evals, SK.quad_step
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
        mesh_t = None
        if mesh is not None and mesh.size > 1 and cur_n >= 2 * mesh.size and \
                cur_n % (2 * mesh.size) == 0:
            mesh_t = _MeshTables(mesh, tables, kind)
        lap = Timer.laps(f"zk_{kind}")
        for j in range(num_rounds):
            lap()
            if mesh_t is None and host is None and cur_n <= HP.HOST_N:
                host = mle.decode_tables([p.Z for p in tables])
            if host is not None:
                v = host_evals(*host)
            else:
                if pending is None:
                    pending = mesh_t.evals() if mesh_t is not None else \
                        evals(*(p.Z for p in tables))
                v = F.decode_fr(pending)
            lap("evals")
            poly = UniPoly.from_evals([v[0], (claim_per_round - v[0]) % FR_MOD, *v[1:]])
            comm_poly = commit(poly.as_vec(), blinds_poly[j], gens_n)
            comm_poly.append_to_transcript(b"comm_poly", transcript)
            comm_polys.append(comm_poly)

            r_j = transcript.challenge_scalar(b"challenge_nextround")
            lap("commit_poly")
            if host is not None:
                host = [HP.fold_top(t, r_j) for t in host]
            elif mesh_t is not None:
                r_dev = mle.encode_scalar(r_j, dev)
                if mesh_t.can_step():
                    pending = mesh_t.step(r_dev)
                else:
                    mesh_t.fold_gather(r_dev)
                    mesh_t = None
                    pending = None
            else:
                r_dev = mle.encode_scalar(r_j, dev)
                if cur_n // 2 <= max(HP.HOST_N, 1):
                    folded = SK.fold([p.Z for p in tables], r_dev)
                    pending = None
                else:
                    *folded, pending = step(*(p.Z for p in tables), r_dev)
                for p, z in zip(tables, folded):
                    p.rebind(z)
            cur_n //= 2
            lap("fold")

            blind_sc = blind_claim if j == 0 else blinds_evals[j - 1]
            proof, eval_, comm_eval = ZKSumcheckInstanceProof._round_tail(
                poly, r_j, claim_per_round, comm_claim_per_round,
                blinds_poly[j], blinds_evals[j], blind_sc,
                gens_1, gens_n, transcript, random_tape,
            )
            lap("round_tail")
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
                                       gens_1, gens_n, transcript, random_tape, mesh=None):
        """ZK sumcheck of sum tau*(Az*Bz - Cz) (sumcheck.rs:465-649)."""
        return ZKSumcheckInstanceProof._rounds(
            "cubic", claim, blind_claim, num_rounds,
            [poly_tau, poly_Az, poly_Bz, poly_Cz], gens_1, gens_n, transcript, random_tape,
            mesh)

    @staticmethod
    def prove_quad(claim: int, blind_claim: int, num_rounds: int,
                   poly_z, poly_ABC, gens_1, gens_n, transcript, random_tape, mesh=None):
        """ZK sumcheck of sum z*ABC (sumcheck.rs:657-811)."""
        return ZKSumcheckInstanceProof._rounds(
            "quad", claim, blind_claim, num_rounds,
            [poly_z, poly_ABC], gens_1, gens_n, transcript, random_tape, mesh)
