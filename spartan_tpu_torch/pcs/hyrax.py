"""Hyrax polynomial commitment scheme (sqrt-n matrix commitment).

Counterpart of ``spartan_tpu/pcs/hyrax.py`` (the reference's PolyCommitment
machinery, hyrax.rs:19-152, duplicated at r1csproof.rs:22-145): the
evaluation table Z is viewed as an L_size x R_size matrix, committed with
one Pedersen point per row (one batched device MSM, ``commit_rows``), and
an evaluation at r reduces to a log-size inner-product argument on the
L-side-bound vector.

Transcript labels and append orders match the reference byte-for-byte.
"""

from __future__ import annotations

from dataclasses import dataclass

from spartan_tpu_torch.core import mle
from spartan_tpu_torch.core.commitments import commit_rows, commit_scalar
from spartan_tpu_torch.core.group import GroupElem
from spartan_tpu_torch.core.mle import DensePolynomial, EqPolynomial
from spartan_tpu_torch.core.nizk import DotProductProofGens, DotProductProofLog
from spartan_tpu_torch.ops import curve as CU
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import msm as MSM
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.utils.math import pow2


class PolyCommitmentGens:
    """Generators sized to the R-side of the factored lens (hyrax.rs:25-31)."""

    def __init__(self, num_vars: int, label: bytes):
        _, right = EqPolynomial.compute_factored_lens(num_vars)
        self.gens = DotProductProofGens(pow2(right), label)


@dataclass
class PolyCommitmentBlinds:
    blinds: list[int]


@dataclass
class PolyCommitment:
    """One Pedersen point per matrix row (hyrax.rs:39-52)."""

    C: list[GroupElem]

    def append_to_transcript(self, label: bytes, transcript) -> None:
        transcript.append_message(label, b"poly_commitment_begin")
        for c in self.C:
            c.append_to_transcript(b"poly_commitment_share", transcript)
        transcript.append_message(label, b"poly_commitment_end")


def commit_poly(poly: DensePolynomial, gens: PolyCommitmentGens, random_tape=None,
                mesh=None):
    """Commit Z row-by-row; blinds from the tape or zero (hyrax.rs:283-308).

    The reference's rayon-parallel ``commit_inner`` hot loop
    (hyrax.rs:253-267) is one batched device MSM here; with ``mesh`` its
    rows are sharded over the ranks.
    """
    ell = poly.num_vars
    left, right = EqPolynomial.compute_factored_lens(ell)
    L_size, R_size = pow2(left), pow2(right)
    assert L_size * R_size == poly.len

    if random_tape is not None:
        blinds = random_tape.random_vector(b"poly_blinds", L_size)
    else:
        blinds = [0] * L_size

    from spartan_tpu_torch.core import hostpath as HP
    from spartan_tpu_torch.core.commitments import commit

    if L_size * (R_size + 1) <= HP.HOST_COMMIT_POINTS:
        Zh = poly.to_ints()
        C = [commit(Zh[i * R_size:(i + 1) * R_size], blinds[i], gens.gens.gens_n)
             for i in range(L_size)]
        return PolyCommitment(C), PolyCommitmentBlinds(blinds)

    Z = poly.Z.reshape(L_size, R_size, -1)
    blinds_mont = F.encode_fr(blinds, device=poly.Z.device)
    pts = commit_rows(Z, blinds_mont, gens.gens.gens_n, mesh=mesh)
    C = [GroupElem(p) for p in CU.decode_points(pts)]
    return PolyCommitment(C), PolyCommitmentBlinds(blinds)


@dataclass
class PolyEvalProof:
    """Opening of a committed polynomial at point r (hyrax.rs:54-152)."""

    proof: DotProductProofLog

    PROTOCOL = b"polynomial evaluation proof"

    @staticmethod
    def prove(poly: DensePolynomial, blinds: PolyCommitmentBlinds | None,
              r: list[int], Zr: int, blind_Zr: int | None,
              gens: PolyCommitmentGens, transcript, random_tape, mesh=None):
        transcript.append_protocol_name(PolyEvalProof.PROTOCOL)
        assert poly.num_vars == len(r)

        left, right = EqPolynomial.compute_factored_lens(len(r))
        L_size, R_size = pow2(left), pow2(right)
        blind_vals = blinds.blinds if blinds is not None else [0] * L_size
        assert len(blind_vals) == L_size
        bz = blind_Zr if blind_Zr is not None else 0

        dev = poly.Z.device
        eq = EqPolynomial(r)
        L_dev, R_dev = eq.compute_factored_evals(dev)
        from spartan_tpu_torch.core import hostpath as HP
        from spartan_tpu_torch.utils.timer import Timer

        with Timer(f"open_bound_LZ[{L_size}x{R_size}]"):
            if poly.len <= HP.HOST_N:
                L_host = HP.eq_evals(r[:left])
                Zh = poly.to_ints()
                LZ_host = [sum(L_host[i] * Zh[i * R_size + j] % FR_MOD
                               for i in range(L_size)) % FR_MOD
                           for j in range(R_size)]
                LZ = F.encode_fr(LZ_host, device=dev)
            else:
                LZ = poly.bound(L_dev, L_size, R_size, mesh=mesh)
                L_host = F.decode_fr(L_dev)
        LZ_blind = sum(b * l for b, l in zip(blind_vals, L_host)) % FR_MOD

        with Timer(f"open_dotp_log[{R_size}]"):
            proof, _Cx, C_Zr_prime = DotProductProofLog.prove(
                gens.gens, transcript, random_tape, LZ, LZ_blind, R_dev,
                Zr, bz,
            )
        return PolyEvalProof(proof), C_Zr_prime

    def verify(self, gens: PolyCommitmentGens, transcript, r: list[int],
               C_Zr: GroupElem, comm: PolyCommitment) -> None:
        from spartan_tpu_torch.utils.timer import Timer

        with Timer(f"v_polyeval[L={len(comm.C)}]"):
            self._verify_inner(gens, transcript, r, C_Zr, comm)

    def _verify_inner(self, gens: PolyCommitmentGens, transcript, r: list[int],
                      C_Zr: GroupElem, comm: PolyCommitment) -> None:
        transcript.append_protocol_name(PolyEvalProof.PROTOCOL)
        from spartan_tpu_torch.core import hostpath as HP
        from spartan_tpu_torch.ops import curve_host as CH

        left, right = EqPolynomial.compute_factored_lens(len(r))
        R_size = pow2(right)
        if R_size <= HP.HOST_MSM_N:
            # all-host verify: eq tables are a few thousand modmuls and the
            # MSMs run on the C backend, with no device work at all (the
            # reference's verify is all-CPU too, r1csproof.rs:463)
            L_host = HP.eq_evals(r[:left])
            R_host = HP.eq_evals(r[left:])
            C_LZ = GroupElem(CH.msm(L_host, [c.p for c in comm.C]))
            self.proof.verify(R_size, gens.gens, transcript, R_host, C_LZ, C_Zr)
            return

        dev = gens.gens.gens_n.device
        eq = EqPolynomial(r)
        L_dev, R_dev = eq.compute_factored_evals(dev)

        # C_LZ = <L, comm.C> (one small MSM, hyrax.rs:133)
        L_host = F.decode_fr(L_dev)
        if len(comm.C) <= HP.HOST_MSM_N:
            C_LZ = GroupElem(CH.msm(L_host, [c.p for c in comm.C]))
        else:
            pts = CU.encode_points_affine([c.p for c in comm.C], dev)
            C_LZ_pt = MSM.msm(pts, F.encode_canonical(L_host, dev))
            C_LZ = GroupElem(CU.decode_points(tuple(a.unsqueeze(0) for a in C_LZ_pt))[0])

        self.proof.verify(R_dev.shape[0], gens.gens, transcript, R_dev, C_LZ, C_Zr)

    def verify_plain(self, gens: PolyCommitmentGens, transcript, r: list[int],
                     Zr: int, comm: PolyCommitment) -> None:
        """Verify an opening to the public value Zr (blind 0)."""
        C_Zr = commit_scalar(Zr, 0, gens.gens.gens_1)
        self.verify(gens, transcript, r, C_Zr, comm)
