"""KZG polynomial commitments: O(1) proofs behind a trusted setup.

Counterpart of ``spartan_tpu/pcs/kzg.py`` (the reference's kzg.rs): the
powers-of-tau SRS (setup, save, load), commitments and quotient openings
as MSMs on kernels H3/H4 (the host C MSM up to
``hostpath.HOST_COMMIT_POINTS`` points), and the pairing checks on the
host (``ops/pairing.py``). The reference's sequential synthetic division by
(x - z) (kzg.rs:231-256) is the suffix-Horner form

    q_i = sum_{j > i} p_j z^(j-i-1) = z^-(i+1) * S_{i+1},  S_i = sum_{j >= i} p_j z^j,

three log-step scans of H1 products and sums (``fr.scan_mul`` for the
powers of z and of z^-1, ``fr.scan_add`` for the suffix sums). At z = 0
the quotient is the coefficient shift.

The SRS is generated on the device: the powers of tau by a product scan,
the points by the fixed-base table of ``core/commitments.py``. Its file
has the JAX package's npz layout (keys ``x``, ``y``, ``inf``, ``tau_g2``,
``g2``; coordinates as 16 limbs of 16 bits), so either package loads the
other's SRS.

Like the reference (kzg.rs:149-154), the "multilinear" wrappers commit to
the evaluation vector directly as monomial coefficients.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from spartan_tpu_torch import device as DEV
from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.core.group import GroupElem
from spartan_tpu_torch.ops import curve as CU
from spartan_tpu_torch.ops import curve_host as CH
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import msm as MSM
from spartan_tpu_torch.ops import pairing as PR
from spartan_tpu_torch.ops.fields_host import FR_MOD, fr_from_bytes, fr_inv
from spartan_tpu_torch.ops.limbs import (
    NUM_LIMBS,
    limbs16_to_32,
    limbs32_to_16,
    to_numpy,
    to_tensor,
)
from spartan_tpu_torch.utils.errors import ProofVerifyError
from spartan_tpu_torch.utils.timer import Timer

fr = F.fr


def k_powers(z, n: int):
    """[1, z, z^2, ..., z^(n-1)], Montgomery [n, 8], from z [8] Montgomery."""
    one = fr.one((1,), z.device)
    if n <= 1:
        return one[:n]
    return torch.cat((one, fr.scan_mul(z.expand(n - 1, NUM_LIMBS))), dim=0)


def k_quotient(p, zpow, zinv):
    """Coefficients [n - 1, 8] of (p(x) - p(z)) / (x - z) for z != 0, from
    p [n, 8], zpow = k_powers(z, n) and zinv = z^-1 [8] (Montgomery)."""
    n = p.shape[0]
    if n <= 1:
        return p[:0]
    suffix = fr.scan_add(fr.mul(p, zpow), reverse=True)       # S_0 .. S_{n-1}
    zinvpow = fr.scan_mul(zinv.expand(n - 1, NUM_LIMBS))      # z^-1 .. z^-(n-1)
    return fr.mul(suffix[1:], zinvpow)


def _srs_file(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


class KZGSrs:
    """Powers of tau: [tau^i]G1 (affine tensors on the device), [tau]G2
    and G2 (host points) (kzg.rs:22-121)."""

    def __init__(self, powers_g1, tau_g2, g2, size: int):
        self.powers_g1 = powers_g1  # affine (x, y, inf), [size]
        self.tau_g2 = tau_g2
        self.g2 = g2
        self.size = size

    @staticmethod
    def setup_from_seed(max_degree: int, seed: int, device=None) -> "KZGSrs":
        """Deterministic SRS (TESTING ONLY: tau is derivable from the seed),
        the JAX package's tau for the same seed."""
        tau = int.from_bytes(
            hashlib.sha256(b"spartan_tpu.kzg.tau" + seed.to_bytes(8, "little")).digest(),
            "little") % FR_MOD
        return KZGSrs.setup_from_tau(max_degree, tau, device)

    @staticmethod
    def setup_from_tau(max_degree: int, tau: int, device=None) -> "KZGSrs":
        """max_degree + 1 points [tau^i]G1. Up to ``HOST_FIXED_BASE_N``
        points the powers are host ints and the points host C scalar
        multiples; above it the powers are a product scan on the device and
        the points come from the fixed-base table there."""
        from spartan_tpu_torch.core import commitments as CM

        dev = DEV.current() if device is None else torch.device(device)
        n = max_degree + 1
        with Timer("srs.tau_powers"):
            if n <= CM.HOST_FIXED_BASE_N:
                powers = [1] * n
                for i in range(1, n):
                    powers[i] = powers[i - 1] * tau % FR_MOD
            else:
                powers = fr.from_mont(k_powers(F.encode_fr([tau], device=dev)[0], n))
        with Timer("srs.g1_points"):
            powers_g1 = CM.points_from_scalars(powers, dev)
        with Timer("srs.tau_g2"):
            tau_g2 = PR.g2_mul(tau, PR.G2_GEN)
        return KZGSrs(powers_g1, tau_g2, PR.G2_GEN, n)

    def max_degree(self) -> int:
        return self.size - 1

    def host_points(self, n: int) -> list:
        """The first n points of the SRS as host affine points."""
        from spartan_tpu_torch.core.commitments import _decode_affine

        return _decode_affine(tuple(a[:n] for a in self.powers_g1))

    def save_to_file(self, path: str) -> None:
        """Write the SRS in the JAX package's npz layout (written to a
        temporary file, then renamed)."""
        out = _srs_file(path)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        x, y, inf = self.powers_g1
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as fh:
                np.savez(fh, x=limbs32_to_16(to_numpy(x)), y=limbs32_to_16(to_numpy(y)),
                         inf=inf.to("cpu").numpy(),
                         tau_g2=np.array([str(v) for v in sum(self.tau_g2, ())]),
                         g2=np.array([str(v) for v in sum(self.g2, ())]))
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @staticmethod
    def load_from_file(path: str, device=None) -> "KZGSrs":
        """Read an SRS file of either package onto ``device``."""
        dev = DEV.current() if device is None else torch.device(device)
        # plain numeric/str arrays only: never allow_pickle on files that
        # may come from outside (arbitrary-code-execution vector)
        with np.load(_srs_file(path)) as d:
            powers = (to_tensor(limbs16_to_32(d["x"]), dev), to_tensor(limbs16_to_32(d["y"]), dev),
                      torch.from_numpy(np.asarray(d["inf"], dtype=bool)).to(dev))
            t = [int(s) for s in d["tau_g2"]]
            g = [int(s) for s in d["g2"]]
        return KZGSrs(powers, ((t[0], t[1]), (t[2], t[3])),
                      ((g[0], g[1]), (g[2], g[3])), int(powers[0].shape[0]))

    @staticmethod
    def load_or_generate(path: str, max_degree: int, seed: int, device=None) -> "KZGSrs":
        """The SRS at ``path`` if it holds more than max_degree points,
        else a new one from ``seed``, saved there."""
        try:
            srs = KZGSrs.load_from_file(path, device)
            if srs.size > max_degree:
                return srs
        except (OSError, KeyError, ValueError):
            pass
        srs = KZGSrs.setup_from_seed(max_degree, seed, device)
        with Timer("srs.save"):
            srs.save_to_file(path)
        return srs


def _commit_msm(srs: KZGSrs, coeffs_mont, mesh=None) -> GroupElem:
    """sum_i c_i [tau^i]G1 for coefficients [n, 8] Montgomery; with ``mesh``
    the points are sharded over the ranks (``msm_sharded``)."""
    n = coeffs_mont.shape[0]
    if n > srs.size:
        raise ValueError(f"polynomial of {n} coefficients exceeds the SRS ({srs.size})")
    if n <= HP.HOST_COMMIT_POINTS:
        return GroupElem(CH.msm(F.decode_fr(coeffs_mont), srs.host_points(n)))
    pts = tuple(a[:n] for a in srs.powers_g1)
    if mesh is not None and mesh.size > 1 and n % mesh.size == 0 and n >= 4 * mesh.size:
        from spartan_tpu_torch.parallel.mesh import shard_table
        from spartan_tpu_torch.parallel.msm_sharded import msm_sharded

        out = msm_sharded(mesh, tuple(shard_table(mesh, a) for a in pts),
                          fr.from_mont(shard_table(mesh, coeffs_mont)))
    else:
        out = MSM.msm(pts, fr.from_mont(coeffs_mont))
    return GroupElem(CU.decode_points(tuple(a.unsqueeze(0) for a in out))[0])


@dataclass
class KZGCommitment:
    """One G1 point (kzg.rs:123-155)."""

    commitment: GroupElem

    @staticmethod
    def commit(coeffs_mont, srs: KZGSrs) -> "KZGCommitment":
        return KZGCommitment(_commit_msm(srs, coeffs_mont))

    def append_to_transcript(self, label: bytes, transcript) -> None:
        transcript.append_message(label, self.commitment.compress())


def _evaluate(coeffs_mont, point: int):
    """(p(point), the powers of point [n, 8] Montgomery)."""
    from spartan_tpu_torch.core.mle import k_dot

    dev = coeffs_mont.device
    with Timer.stage("kzg.powers", dev):
        zpow = k_powers(F.encode_fr([point], device=dev)[0], coeffs_mont.shape[0])
    return F.decode_fr(k_dot(coeffs_mont, zpow).unsqueeze(0))[0], zpow


@dataclass
class KZGProof:
    """One G1 quotient commitment (kzg.rs:165-257)."""

    proof: GroupElem

    @staticmethod
    def prove(coeffs_mont, point: int, srs: KZGSrs, mesh=None) -> tuple["KZGProof", int]:
        n = coeffs_mont.shape[0]
        eval_, zpow = _evaluate(coeffs_mont, point)
        if n <= 1:
            return KZGProof(GroupElem.identity()), eval_
        dev = coeffs_mont.device
        with Timer.stage("kzg.quotient", dev):
            if point % FR_MOD == 0:
                # (p(x) - p(0)) / x is the coefficient shift; the
                # suffix-Horner form needs z^-1
                q = coeffs_mont[1:]
            else:
                zinv = F.encode_fr([fr_inv(point)], device=dev)[0]
                q = k_quotient(coeffs_mont, zpow, zinv)
        del zpow   # 1 GB at 2^25 coefficients, freed before the MSM
        return KZGProof(_commit_msm(srs, q, mesh=mesh)), eval_

    def verify(self, commitment: KZGCommitment, point: int, eval_: int,
               srs: KZGSrs) -> bool:
        """e(C - y*G1, G2) == e(pi, tau*G2 - z*G2) (kzg.rs:194-217)."""
        lhs_g1 = CH.add(commitment.commitment.p, CH.neg(CH.scalar_mul(eval_, CH.GEN)))
        rhs_g2 = PR.g2_add(srs.tau_g2, PR.g2_neg(PR.g2_mul(point, PR.G2_GEN)))
        return PR.multi_pairing_eq([(lhs_g1, srs.g2)], [(self.proof.p, rhs_g2)])


def _gamma_from_transcript(transcript) -> int:
    """32 challenge bytes -> canonical scalar, else 1 (kzg.rs:276-278)."""
    v = fr_from_bytes(transcript.challenge_bytes(b"batch_challenge", 32))
    return v if v is not None else 1


def _rlc(values: list[int], gamma: int) -> int:
    """sum_i gamma^i values_i."""
    acc, gp = 0, 1
    for v in values:
        acc = (acc + v * gp) % FR_MOD
        gp = gp * gamma % FR_MOD
    return acc


@dataclass
class KZGBatchProof:
    """Gamma-RLC batch opening at one point (kzg.rs:259-353)."""

    proof: GroupElem

    @staticmethod
    def batch_prove(polys_mont: list, point: int, evals: list[int],
                    srs: KZGSrs, transcript) -> "KZGBatchProof":
        gamma = _gamma_from_transcript(transcript)
        dev = polys_mont[0].device
        combined = fr.zeros((max(p.shape[0] for p in polys_mont),), dev)
        gp = 1
        for p in polys_mont:
            n = p.shape[0]
            combined[:n] = fr.add(combined[:n], fr.mul(p, F.encode_fr([gp], device=dev)[0]))
            gp = gp * gamma % FR_MOD
        proof, _ = KZGProof.prove(combined, point, srs)
        return KZGBatchProof(proof.proof)

    def batch_verify(self, commitments: list[KZGCommitment], point: int,
                     evals: list[int], srs: KZGSrs, transcript) -> bool:
        gamma = _gamma_from_transcript(transcript)
        comb = None
        gp = 1
        for c in commitments:
            comb = CH.add(comb, CH.scalar_mul(gp, c.commitment.p))
            gp = gp * gamma % FR_MOD
        return KZGProof(self.proof).verify(
            KZGCommitment(GroupElem(comb)), point, _rlc(evals, gamma), srs)


# ---------------------------------------------------------------------------
# Hyrax-replacement wrappers (kzg.rs:359-518) and the adapter the lookup
# argument's derefs use (sparse_mlpoly_full.SparseMatPolyCommitmentGens)
# ---------------------------------------------------------------------------

class KZGPolyCommitmentGens:
    def __init__(self, srs: KZGSrs):
        self.srs = srs

    def commit(self, poly, mesh=None) -> "KZGPolyCommitment":
        """Commit a DensePolynomial's evaluation vector (as coefficients)."""
        return KZGPolyCommitment(_commit_msm(self.srs, poly.Z, mesh=mesh))

    def prove_eval(self, poly, _r_joint, _claim, transcript,
                   mesh=None) -> "KZGPolyEvalProof":
        """The reference's KZG derefs flow (sparse_mlpoly_full.rs:503-550):
        draw a univariate challenge point and open the coefficients there."""
        point = transcript.challenge_scalar(b"kzg_eval_point")
        proof, eval_ = KZGProof.prove(poly.Z, point, self.srs, mesh=mesh)
        return KZGPolyEvalProof(proof.proof, eval_)

    def verify_eval(self, proof: "KZGPolyEvalProof", comm: "KZGPolyCommitment",
                    _r_joint, _claim, transcript) -> None:
        """REFERENCE PARITY ONLY: NOT a sound link to the multilinear claim.

        Like the reference's kzg feature (sparse_mlpoly_full.rs:552-596),
        this checks a univariate opening at a fresh transcript point but
        never ties ``_claim`` (the joint multilinear derefs evaluation at
        ``_r_joint``) to the commitment. Hyrax mode (the default) makes the
        sound check; pcs='kzg' is for parity with the reference.
        """
        point = transcript.challenge_scalar(b"kzg_eval_point")
        ok = KZGProof(proof.proof).verify(
            KZGCommitment(comm.commitment), point, proof.eval, self.srs)
        if not ok:
            raise ProofVerifyError("KZG derefs opening failed")


@dataclass
class KZGPolyCommitment:
    commitment: GroupElem

    def append_to_transcript(self, label: bytes, transcript) -> None:
        transcript.append_message(label, self.commitment.compress())


@dataclass
class KZGPolyEvalProof:
    proof: GroupElem
    eval: int

    @staticmethod
    def prove(evals_mont, point: int, gens: KZGPolyCommitmentGens) -> "KZGPolyEvalProof":
        p, e = KZGProof.prove(evals_mont, point, gens.srs)
        return KZGPolyEvalProof(p.proof, e)

    def verify(self, comm: KZGPolyCommitment, point: int,
               gens: KZGPolyCommitmentGens) -> bool:
        return KZGProof(self.proof).verify(
            KZGCommitment(comm.commitment), point, self.eval, gens.srs)


@dataclass
class KZGBatchedCommitment:
    commitments: list[GroupElem]

    @staticmethod
    def commit(polys_mont: list, gens: KZGPolyCommitmentGens) -> "KZGBatchedCommitment":
        return KZGBatchedCommitment(
            [KZGCommitment.commit(p, gens.srs).commitment for p in polys_mont])

    def append_to_transcript(self, label: bytes, transcript) -> None:
        transcript.append_message(label, b"kzg_batch_begin")
        for c in self.commitments:
            transcript.append_message(b"kzg_batch_elem", c.compress())
        transcript.append_message(label, b"kzg_batch_end")


@dataclass
class KZGBatchedEvalProof:
    proof: GroupElem
    evals: list[int]

    @staticmethod
    def prove(polys_mont: list, point: int, gens: KZGPolyCommitmentGens,
              transcript) -> "KZGBatchedEvalProof":
        evals = [_evaluate(p, point)[0] for p in polys_mont]
        bp = KZGBatchProof.batch_prove(polys_mont, point, evals, gens.srs, transcript)
        return KZGBatchedEvalProof(bp.proof, evals)

    def verify(self, comm: KZGBatchedCommitment, point: int,
               gens: KZGPolyCommitmentGens, transcript) -> bool:
        return KZGBatchProof(self.proof).batch_verify(
            [KZGCommitment(c) for c in comm.commitments],
            point, self.evals, gens.srs, transcript)
