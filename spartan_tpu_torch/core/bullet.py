"""Bulletproof-style inner product reduction (log-size IPA).

Counterpart of ``spartan_tpu/core/bullet.py`` (reference src/nizk/bullet.rs).
Vectors and generators stay on the device while they are longer than
``hostpath.HOST_MSM_N``; each such halving round issues one (n/2+2)-point
MSM per side (L, R), folds generators with a batched scalar ladder, and
folds the scalar vectors with two field ops. Shorter rounds run on the host
C backend. The verifier recomputes the s-vector from challenge products and
does 3 MSMs (bullet.rs:130-200).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.core.group import GroupElem
from spartan_tpu_torch.core import mle
from spartan_tpu_torch.ops import curve_host as CH
from spartan_tpu_torch.ops import curve as CU
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import msm as MSM
from spartan_tpu_torch.ops.fields_host import FR_MOD, fr_inv
from spartan_tpu_torch.utils.errors import ProofVerifyError
from spartan_tpu_torch.utils.math import log_2
from spartan_tpu_torch.utils.timer import Timer

fr = F.fr


def _msm_with_extras_host(G_host, scalars, extra_points, extra_scalars):
    with Timer("bullet.host_msm"):
        pts = list(G_host) + [p.p for p in extra_points]
        return GroupElem(CH.msm(list(scalars) + [s % FR_MOD for s in extra_scalars], pts))


def _fold_points_host(G_host, u: int, u_inv: int):
    half = len(G_host) // 2
    return CH.dual_mul_many(u_inv, u, G_host[:half], G_host[half:])


def _msm_with_extras(G_affine, scalars_mont, extra_points: list, extra_scalars: list[int]):
    """<scalars, G> + sum extra_scalar_i * extra_point_i -> host GroupElem."""
    dev = scalars_mont.device
    ex = CU.encode_points_affine([p.p for p in extra_points], dev)
    pts = tuple(torch.cat((g, e), dim=0) for g, e in zip(G_affine, ex))
    sc_canon = fr.from_mont(scalars_mont)
    extra = F.encode_canonical([s % FR_MOD for s in extra_scalars], dev)
    sc = torch.cat((sc_canon, extra), dim=0)
    pt = MSM.msm(pts, sc)
    return GroupElem(CU.decode_points(tuple(a.unsqueeze(0) for a in pt))[0])


def _fold_points(G_affine, u: int, u_inv: int):
    """G' = u_inv * G_L + u * G_R (bullet.rs:85-89), device batched."""
    n = G_affine[0].shape[0]
    half = n // 2
    sc = F.encode_canonical([u_inv % FR_MOD] * half + [u % FR_MOD] * half,
                            G_affine[0].device)
    prods = CU.scalar_mul(sc, CU.from_affine(*G_affine))
    left = tuple(a[:half] for a in prods)
    right = tuple(a[half:] for a in prods)
    summed = CU.padd(left, right)
    return CU.batch_normalize(summed)


@dataclass
class BulletReductionProof:
    L_vec: list[GroupElem]
    R_vec: list[GroupElem]

    @staticmethod
    def prove(
        transcript,
        Q: GroupElem,
        G_affine,           # affine (x, y, inf) tensors, n points
        H: GroupElem,
        a_mont,             # [n, 8] Montgomery limbs
        b_mont,             # [n, 8] Montgomery limbs
        blind: int,
        blinds_vec: list[tuple[int, int]],
    ):
        """Returns (proof, Gamma, a_hat, b_hat, g_hat, rhat_Gamma).

        Follows bullet.rs:24-126; Gamma is the initial commitment
        <a,G> + <a,b> Q + blind H (the caller never uses it, kept for parity).
        """
        n = a_mont.shape[0]
        lg_n = log_2(n)
        assert len(blinds_vec) == lg_n
        assert G_affine[0].shape[0] == n

        host = n <= HP.HOST_MSM_N  # small-size host tail (see core/hostpath.py)
        tail = None   # the span of the host tail, from its decode to the last round
        if host:
            tail = Timer("bullet.host_tail")
            a = F.decode_fr(a_mont)
            b = F.decode_fr(b_mont)
            G = CU.decode_points(CU.from_affine(*G_affine))
            ab = HP.dot(a, b)
            Gamma = _msm_with_extras_host(G, a, [Q, H], [ab, blind])
        else:
            a, b = a_mont, b_mont
            G = G_affine
            ab = mle.decode_scalar(mle.k_dot(a_mont, b_mont))
            Gamma = _msm_with_extras(G_affine, a_mont, [Q, H], [ab, blind])
        blind_Gamma = blind % FR_MOD

        L_vec: list[GroupElem] = []
        R_vec: list[GroupElem] = []

        for i in range(lg_n):
            if not host and a.shape[0] <= HP.HOST_MSM_N:
                host = True
                tail = Timer("bullet.host_tail")
                a = F.decode_fr(a)
                b = F.decode_fr(b)
                G = CU.decode_points(CU.from_affine(*G))
            half = (len(a) if host else a.shape[0]) // 2
            blind_L, blind_R = blinds_vec[i]

            if host:
                a_L, a_R = a[:half], a[half:]
                b_L, b_R = b[:half], b[half:]
                c_L = HP.dot(a_L, b_R)
                c_R = HP.dot(a_R, b_L)
                L = _msm_with_extras_host(G[half:], a_L, [Q, H], [c_L, blind_L])
                R = _msm_with_extras_host(G[:half], a_R, [Q, H], [c_R, blind_R])
            else:
                a_L, a_R = a[:half], a[half:]
                b_L, b_R = b[:half], b[half:]
                G_L = tuple(g[:half] for g in G)
                G_R = tuple(g[half:] for g in G)
                c_L = mle.decode_scalar(mle.k_dot(a_L, b_R))
                c_R = mle.decode_scalar(mle.k_dot(a_R, b_L))
                L = _msm_with_extras(G_R, a_L, [Q, H], [c_L, blind_L])
                R = _msm_with_extras(G_L, a_R, [Q, H], [c_R, blind_R])

            L.append_to_transcript(b"L", transcript)
            R.append_to_transcript(b"R", transcript)
            u = transcript.challenge_scalar(b"u")
            u_inv = fr_inv(u)

            if host:
                G = _fold_points_host(G, u, u_inv)
                a = [(u * a_L[k] + u_inv * a_R[k]) % FR_MOD for k in range(half)]
                b = [(u_inv * b_L[k] + u * b_R[k]) % FR_MOD for k in range(half)]
            else:
                G = _fold_points(G, u, u_inv)
                u_m = mle.encode_scalar(u, a.device)
                u_inv_m = mle.encode_scalar(u_inv, a.device)
                a = fr.add(fr.mul(u_m, a_L), fr.mul(u_inv_m, a_R))
                b = fr.add(fr.mul(u_inv_m, b_L), fr.mul(u_m, b_R))
            blind_Gamma = (u * u % FR_MOD * blind_L + blind_Gamma + u_inv * u_inv % FR_MOD * blind_R) % FR_MOD

            L_vec.append(L)
            R_vec.append(R)
        if tail is not None:
            tail.stop()

        if host:
            a_hat = a[0]
            b_hat = b[0]
            g_hat = GroupElem(G[0])
        else:
            a_hat = F.decode_fr(a)[0]
            b_hat = F.decode_fr(b)[0]
            g_hat = GroupElem(CU.decode_points(CU.from_affine(*G))[0])
        return (
            BulletReductionProof(L_vec, R_vec),
            Gamma,
            a_hat,
            b_hat,
            g_hat,
            blind_Gamma,
        )

    def verify(self, n: int, b_vec_mont, transcript, Gamma: GroupElem, G_affine):
        """Returns (g_hat, Gamma_hat, b_hat) per bullet.rs:130-173.

        ``b_vec_mont`` may be a host list of canonical ints and
        ``G_affine`` a MultiCommitGens (all-host verify: the generator
        table comes from the gens' cached host points, no device work)."""
        gens_obj = G_affine if hasattr(G_affine, "host_points") else None
        if gens_obj is not None:
            G_affine = gens_obj.G
        lg_n = log_2(n)
        if len(self.L_vec) != lg_n or len(self.R_vec) != lg_n:
            raise ProofVerifyError("bullet: wrong number of rounds")

        u_vec = []
        for i in range(lg_n):
            self.L_vec[i].append_to_transcript(b"L", transcript)
            self.R_vec[i].append_to_transcript(b"R", transcript)
            u_vec.append(transcript.challenge_scalar(b"u"))

        u_inv_vec = [fr_inv(u) for u in u_vec]
        # s[i] = prod_j u_j^{+-1} by bit j of i (bullet.rs:183-200), built
        # by doubling expansion (2n modmuls, not n*lg_n). Each split puts
        # its challenge in the NEW top bit, and the MSB of i must select
        # u_0 — so process the challenges in reverse order.
        s = [1]
        for u, ui in zip(reversed(u_vec), reversed(u_inv_vec)):
            s = [x * ui % FR_MOD for x in s] + [x * u % FR_MOD for x in s]

        u_sq = [u * u % FR_MOD for u in u_vec]
        u_sq_inv = [fr_inv(x) for x in u_sq]
        if n <= HP.HOST_MSM_N:
            if gens_obj is not None:
                G_host = gens_obj.host_points()[0][:n]
            else:
                G_host = CU.decode_points(CU.from_affine(*G_affine))[:n]
            g_hat = GroupElem(CH.msm(s, G_host))
            b_host = b_vec_mont if isinstance(b_vec_mont, list) \
                else F.decode_fr(b_vec_mont)
            b_hat = HP.dot(s, b_host)
            lr = GroupElem(CH.msm(u_sq + u_sq_inv,
                                  [g.p for g in self.L_vec] + [g.p for g in self.R_vec]))
        else:
            dev = G_affine[0].device
            g_hat_pt = MSM.msm(G_affine, F.encode_canonical(s, dev))
            g_hat = GroupElem(CU.decode_points(tuple(a.unsqueeze(0) for a in g_hat_pt))[0])

            s_mont = F.encode_fr(s, device=dev)
            if isinstance(b_vec_mont, list):
                b_vec_mont = F.encode_fr(b_vec_mont, device=dev)
            b_hat = mle.decode_scalar(mle.k_dot(s_mont, b_vec_mont))

            LR = CU.encode_points_affine(
                [g.p for g in self.L_vec] + [g.p for g in self.R_vec], dev)
            lr_pt = MSM.msm(LR, F.encode_canonical(u_sq + u_sq_inv, dev))
            lr = GroupElem(CU.decode_points(tuple(a.unsqueeze(0) for a in lr_pt))[0])
        Gamma_hat = lr.add(Gamma)
        return g_hat, Gamma_hat, b_hat
