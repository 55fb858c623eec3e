"""Sigma-protocols: zero-knowledge proofs of committed claims.

Counterpart of ``spartan_tpu/core/nizk.py`` (reference src/nizk/mod.rs) — Knowledge,
Equality, Product, and DotProduct proofs (linear and log-size). These are
control-plane protocols over *tiny* vectors (sumcheck round polynomials,
final claims); the only large-vector member is DotProductProofLog, whose
vectors/generators stay on the device and whose heavy lifting is the
bullet reduction (spartan_tpu_torch.core.bullet).

Transcript labels and append orders match the reference byte-for-byte.
"""

from __future__ import annotations

from dataclasses import dataclass

from spartan_tpu_torch.core import mle
from spartan_tpu_torch.core.bullet import BulletReductionProof
from spartan_tpu_torch.core.commitments import MultiCommitGens, commit, commit_scalar
from spartan_tpu_torch.core.group import GroupElem
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.utils.errors import ProofVerifyError
from spartan_tpu_torch.utils.math import log_2

@dataclass
class KnowledgeProof:
    """PoK of (x, r) with C = x*G + r*h (nizk/mod.rs:23-82)."""

    alpha: GroupElem
    z1: int
    z2: int

    PROTOCOL = b"knowledge proof"

    @staticmethod
    def prove(gens_1: MultiCommitGens, transcript, random_tape, x: int, r: int):
        transcript.append_protocol_name(KnowledgeProof.PROTOCOL)
        t1 = random_tape.random_scalar(b"t1")
        t2 = random_tape.random_scalar(b"t2")
        C = commit_scalar(x, r, gens_1)
        C.append_to_transcript(b"C", transcript)
        alpha = commit_scalar(t1, t2, gens_1)
        alpha.append_to_transcript(b"alpha", transcript)
        c = transcript.challenge_scalar(b"c")
        z1 = (x * c + t1) % FR_MOD
        z2 = (r * c + t2) % FR_MOD
        return KnowledgeProof(alpha, z1, z2), C

    def verify(self, gens_1: MultiCommitGens, transcript, C: GroupElem) -> None:
        transcript.append_protocol_name(KnowledgeProof.PROTOCOL)
        C.append_to_transcript(b"C", transcript)
        self.alpha.append_to_transcript(b"alpha", transcript)
        c = transcript.challenge_scalar(b"c")
        lhs = commit_scalar(self.z1, self.z2, gens_1)
        rhs = C.mul(c).add(self.alpha)
        if lhs != rhs:
            raise ProofVerifyError("knowledge proof failed")


@dataclass
class EqualityProof:
    """C1, C2 commit to the same value (nizk/mod.rs:86-150)."""

    alpha: GroupElem
    z: int

    PROTOCOL = b"equality proof"

    @staticmethod
    def prove(gens_1: MultiCommitGens, transcript, random_tape,
              v1: int, s1: int, v2: int, s2: int):
        transcript.append_protocol_name(EqualityProof.PROTOCOL)
        r = random_tape.random_scalar(b"r")
        C1 = commit_scalar(v1, s1, gens_1)
        C1.append_to_transcript(b"C1", transcript)
        C2 = commit_scalar(v2, s2, gens_1)
        C2.append_to_transcript(b"C2", transcript)
        h = GroupElem(_h_host(gens_1))
        alpha = h.mul(r)
        alpha.append_to_transcript(b"alpha", transcript)
        c = transcript.challenge_scalar(b"c")
        z = (c * (s1 - s2) + r) % FR_MOD
        return EqualityProof(alpha, z), C1, C2

    def verify(self, gens_1: MultiCommitGens, transcript, C1: GroupElem, C2: GroupElem) -> None:
        transcript.append_protocol_name(EqualityProof.PROTOCOL)
        C1.append_to_transcript(b"C1", transcript)
        C2.append_to_transcript(b"C2", transcript)
        self.alpha.append_to_transcript(b"alpha", transcript)
        c = transcript.challenge_scalar(b"c")
        Cdiff = C1.add(C2.neg())
        rhs = Cdiff.mul(c).add(self.alpha)
        lhs = GroupElem(_h_host(gens_1)).mul(self.z)
        if lhs != rhs:
            raise ProofVerifyError("equality proof failed")


@dataclass
class ProductProof:
    """Z commits to X*Y (5-response sigma, nizk/mod.rs:154-284)."""

    alpha: GroupElem
    beta: GroupElem
    delta: GroupElem
    z: list[int]

    PROTOCOL = b"product proof"

    @staticmethod
    def prove(gens_1: MultiCommitGens, transcript, random_tape,
              x: int, rX: int, y: int, rY: int, zval: int, rZ: int):
        transcript.append_protocol_name(ProductProof.PROTOCOL)
        b1 = random_tape.random_scalar(b"b1")
        b2 = random_tape.random_scalar(b"b2")
        b3 = random_tape.random_scalar(b"b3")
        b4 = random_tape.random_scalar(b"b4")
        b5 = random_tape.random_scalar(b"b5")

        X = commit_scalar(x, rX, gens_1)
        X.append_to_transcript(b"X", transcript)
        Y = commit_scalar(y, rY, gens_1)
        Y.append_to_transcript(b"Y", transcript)
        Z = commit_scalar(zval, rZ, gens_1)
        Z.append_to_transcript(b"Z", transcript)
        alpha = commit_scalar(b1, b2, gens_1)
        alpha.append_to_transcript(b"alpha", transcript)
        beta = commit_scalar(b3, b4, gens_1)
        beta.append_to_transcript(b"beta", transcript)
        # delta = b3*X + b5*h (commit under generators {X, h})
        delta = X.mul(b3).add(GroupElem(_h_host(gens_1)).mul(b5))
        delta.append_to_transcript(b"delta", transcript)

        c = transcript.challenge_scalar(b"c")
        z = [
            (b1 + c * x) % FR_MOD,
            (b2 + c * rX) % FR_MOD,
            (b3 + c * y) % FR_MOD,
            (b4 + c * rY) % FR_MOD,
            (b5 + c * (rZ - rX * y)) % FR_MOD,
        ]
        return ProductProof(alpha, beta, delta, z), X, Y, Z

    def verify(self, gens_1: MultiCommitGens, transcript,
               X: GroupElem, Y: GroupElem, Z: GroupElem) -> None:
        transcript.append_protocol_name(ProductProof.PROTOCOL)
        X.append_to_transcript(b"X", transcript)
        Y.append_to_transcript(b"Y", transcript)
        Z.append_to_transcript(b"Z", transcript)
        self.alpha.append_to_transcript(b"alpha", transcript)
        self.beta.append_to_transcript(b"beta", transcript)
        self.delta.append_to_transcript(b"delta", transcript)
        z1, z2, z3, z4, z5 = self.z
        c = transcript.challenge_scalar(b"c")
        h = GroupElem(_h_host(gens_1))

        ok = self.alpha.add(X.mul(c)) == commit_scalar(z1, z2, gens_1)
        ok &= self.beta.add(Y.mul(c)) == commit_scalar(z3, z4, gens_1)
        ok &= self.delta.add(Z.mul(c)) == X.mul(z3).add(h.mul(z5))
        if not ok:
            raise ProofVerifyError("product proof failed")


@dataclass
class DotProductProof:
    """Linear-size ZK dot-product opening (nizk/mod.rs:288-401).

    Used with tiny vectors (sumcheck round-poly coefficients), so vectors
    are host ints and the MSMs go through ``commit``.
    """

    delta: GroupElem
    beta: GroupElem
    z: list[int]
    z_delta: int
    z_beta: int

    PROTOCOL = b"dot product proof"

    @staticmethod
    def prove(gens_1: MultiCommitGens, gens_n: MultiCommitGens, transcript, random_tape,
              x_vec: list[int], blind_x: int, a_vec: list[int], y: int, blind_y: int):
        transcript.append_protocol_name(DotProductProof.PROTOCOL)
        n = len(x_vec)
        assert n == len(a_vec) and gens_n.n == n and gens_1.n == 1

        d_vec = random_tape.random_vector(b"d_vec", n)
        r_delta = random_tape.random_scalar(b"r_delta")
        r_beta = random_tape.random_scalar(b"r_beta")

        Cx = commit(x_vec, blind_x, gens_n)
        Cx.append_to_transcript(b"Cx", transcript)
        Cy = commit_scalar(y, blind_y, gens_1)
        Cy.append_to_transcript(b"Cy", transcript)
        transcript.append_scalars(b"a", a_vec)
        delta = commit(d_vec, r_delta, gens_n)
        delta.append_to_transcript(b"delta", transcript)
        dot_ad = mle.compute_dotproduct(a_vec, d_vec)
        beta = commit_scalar(dot_ad, r_beta, gens_1)
        beta.append_to_transcript(b"beta", transcript)

        c = transcript.challenge_scalar(b"c")
        z = [(c * x_vec[i] + d_vec[i]) % FR_MOD for i in range(n)]
        z_delta = (c * blind_x + r_delta) % FR_MOD
        z_beta = (c * blind_y + r_beta) % FR_MOD
        return DotProductProof(delta, beta, z, z_delta, z_beta), Cx, Cy

    def verify(self, gens_1: MultiCommitGens, gens_n: MultiCommitGens, transcript,
               a: list[int], Cx: GroupElem, Cy: GroupElem) -> None:
        assert gens_n.n == len(a) and gens_1.n == 1
        transcript.append_protocol_name(DotProductProof.PROTOCOL)
        Cx.append_to_transcript(b"Cx", transcript)
        Cy.append_to_transcript(b"Cy", transcript)
        transcript.append_scalars(b"a", a)
        self.delta.append_to_transcript(b"delta", transcript)
        self.beta.append_to_transcript(b"beta", transcript)
        c = transcript.challenge_scalar(b"c")

        ok = Cx.mul(c).add(self.delta) == commit(self.z, self.z_delta, gens_n)
        dot_za = mle.compute_dotproduct(self.z, a)
        ok &= Cy.mul(c).add(self.beta) == commit_scalar(dot_za, self.z_beta, gens_1)
        if not ok:
            raise ProofVerifyError("dot product proof failed")


class DotProductProofGens:
    """n generators split (n, 1) as in nizk/mod.rs:405-416."""

    def __init__(self, n: int, label: bytes | None = None, _parts=None):
        self.n = n
        if _parts is not None:
            self.gens_n, self.gens_1 = _parts
        else:
            self.gens_n, self.gens_1 = MultiCommitGens(n + 1, label).split_at(n)


@dataclass
class DotProductProofLog:
    """Log-size dot-product opening over the bullet reduction
    (nizk/mod.rs:420-568). x/a vectors are Montgomery limb tensors."""

    bullet_reduction_proof: BulletReductionProof
    delta: GroupElem
    beta: GroupElem
    z1: int
    z2: int

    PROTOCOL = b"dot product proof (log)"

    @staticmethod
    def prove(gens: DotProductProofGens, transcript, random_tape,
              x_mont, blind_x: int, a_mont, y: int, blind_y: int):
        transcript.append_protocol_name(DotProductProofLog.PROTOCOL)
        n = x_mont.shape[0]
        assert gens.n == n

        d = random_tape.random_scalar(b"d")
        r_delta = random_tape.random_scalar(b"r_delta")
        # NOTE: the reference draws r_beta under the label "r_delta" too
        # (nizk/mod.rs:460) — reproduced for tape compatibility.
        r_beta = random_tape.random_scalar(b"r_delta")
        lg_n = log_2(n)
        v1 = random_tape.random_vector(b"blinds_vec_1", lg_n)
        v2 = random_tape.random_vector(b"blinds_vec_2", lg_n)
        blinds_vec = list(zip(v1, v2))

        from spartan_tpu_torch.core import hostpath as HP
        from spartan_tpu_torch.core.commitments import commit_device
        from spartan_tpu_torch.ops import curve as CU

        if n == 1 or HP.bullet_on_host(n, x_mont.device):
            Cx = commit(F.decode_fr(x_mont), blind_x, gens.gens_n)
        else:   # the bullet's first round runs on the card: so does Cx
            Cx_pt = commit_device(x_mont, mle.encode_scalar(blind_x, x_mont.device),
                                  gens.gens_n)
            Cx = GroupElem(CU.decode_few(Cx_pt)[0])
        Cx.append_to_transcript(b"Cx", transcript)
        Cy = commit_scalar(y, blind_y, gens.gens_1)
        Cy.append_to_transcript(b"Cy", transcript)
        transcript.append_scalars(b"a", F.decode_fr(a_mont))

        r = transcript.challenge_scalar(b"r")
        gens_1_scaled = gens.gens_1.scale(r)

        blind_Gamma = (blind_x + r * blind_y) % FR_MOD
        Q = GroupElem(gens_1_scaled.host_points()[0][0])
        H = GroupElem(_h_host(gens.gens_n))
        (bullet_proof, _Gamma, x_hat, a_hat, g_hat, rhat_Gamma) = BulletReductionProof.prove(
            transcript, Q, gens.gens_n.G, H, x_mont, a_mont, blind_Gamma, blinds_vec
        )
        y_hat = x_hat * a_hat % FR_MOD

        delta = g_hat.mul(d).add(GroupElem(_h_host(gens.gens_1)).mul(r_delta))
        delta.append_to_transcript(b"delta", transcript)
        beta = commit_scalar(d, r_beta, gens_1_scaled)
        beta.append_to_transcript(b"beta", transcript)

        c = transcript.challenge_scalar(b"c")
        z1 = (d + c * y_hat) % FR_MOD
        z2 = (a_hat * (c * rhat_Gamma + r_beta) + r_delta) % FR_MOD
        return DotProductProofLog(bullet_proof, delta, beta, z1, z2), Cx, Cy

    def verify(self, n: int, gens: DotProductProofGens, transcript,
               a_mont, Cx: GroupElem, Cy: GroupElem) -> None:
        """``a_mont`` is the public vector, either a Montgomery limb tensor
        or a host list of canonical ints (the all-host verify path passes a
        list so no device work ever happens)."""
        assert gens.n == n
        transcript.append_protocol_name(DotProductProofLog.PROTOCOL)
        Cx.append_to_transcript(b"Cx", transcript)
        Cy.append_to_transcript(b"Cy", transcript)
        a_is_host = isinstance(a_mont, list)
        transcript.append_scalars(b"a", a_mont if a_is_host
                                  else F.decode_fr(a_mont))

        r = transcript.challenge_scalar(b"r")
        gens_1_scaled = gens.gens_1.scale(r)
        Gamma = Cx.add(Cy.mul(r))

        g_hat, Gamma_hat, a_hat = self.bullet_reduction_proof.verify(
            n, a_mont, transcript, Gamma, gens.gens_n
        )
        self.delta.append_to_transcript(b"delta", transcript)
        self.beta.append_to_transcript(b"beta", transcript)
        c = transcript.challenge_scalar(b"c")

        Q = GroupElem(gens_1_scaled.host_points()[0][0])
        h_scaled = GroupElem(_h_host(gens_1_scaled))
        lhs = Gamma_hat.mul(c).add(self.beta).mul(a_hat).add(self.delta)
        rhs = g_hat.add(Q.mul(a_hat)).mul(self.z1).add(h_scaled.mul(self.z2))
        if lhs != rhs:
            raise ProofVerifyError("dot product proof (log) failed")


def _h_host(gens: MultiCommitGens):
    """Decode gens.h to a host affine point (cached on the gens object)."""
    cached = getattr(gens, "_h_host_cache", None)
    if cached is None:
        from spartan_tpu_torch.core.commitments import _decode_affine

        cached = _decode_affine(tuple(a.unsqueeze(0) for a in gens.h))[0]
        gens._h_host_cache = cached
    return cached
