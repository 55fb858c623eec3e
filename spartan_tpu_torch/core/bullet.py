"""Bulletproof-style inner product reduction (log-size IPA).

Counterpart of ``spartan_tpu/core/bullet.py`` (reference src/nizk/bullet.rs).
The prover halves the vectors lg n times; where each round runs is decided
by its length and the tensors' device (``hostpath.bullet_on_host``): on a
card, rounds longer than ``hostpath.HOST_BULLET_N`` run there, and the rest
(all rounds up to ``HOST_MSM_N`` on the CPU) on the host C backend. A round
on the card:

  * c_L = <a_L, b_R> and c_R = <a_R, b_L> with one H1 product and an exact
    sum, kept on the card as MSM scalars;
  * L and R from one MSM of two scalar rows over G || Q || H (zeros where
    a side has no term; round 0 adds Gamma's row), copied to the host in
    one read and normalised there (``curve.decode_few``);
  * G' = u^-1 G_L + u G_R by H2's double-and-add ladder and one padd, made
    affine again for the next MSM with the product's one inverse taken on
    the host; a and b folded by H1 with u, u^-1 as stride-0 scalars.

Q, H and every round's blinds are uploaded once a reduction, u and u^-1
once a round. At the crossover a, b and G are decoded once and the host
rounds (host C MSMs and ``g1_dual_mul_many`` folds, the ``bullet.host_tail``
span) finish. The proof is the same on either route. The verifier
recomputes the s-vector from challenge products and does 3 MSMs
(bullet.rs:130-200).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.core import mle
from spartan_tpu_torch.core.commitments import _decode_affine
from spartan_tpu_torch.core.group import GroupElem
from spartan_tpu_torch.ops import curve_host as CH
from spartan_tpu_torch.ops import curve as CU
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import msm as MSM
from spartan_tpu_torch.ops.fields_host import FR_MOD, fr_inv
from spartan_tpu_torch.ops.limbs import NUM_LIMBS, ints_to_limbs, to_tensor
from spartan_tpu_torch.utils.errors import ProofVerifyError
from spartan_tpu_torch.utils.math import log_2
from spartan_tpu_torch.utils.timer import Timer

fr = F.fr
_R = (1 << 256) % FR_MOD


def _msm_with_extras_host(G_host, scalars, extra_points, extra_scalars):
    with Timer("bullet.host_msm"):
        pts = list(G_host) + [p.p for p in extra_points]
        return GroupElem(CH.msm(list(scalars) + [s % FR_MOD for s in extra_scalars], pts))


def host_round(G, a, b, Q, H, blind_L: int, blind_R: int, transcript):
    """One round on the host: G host points, a and b canonical ints.
    Returns (L, R, u, u_inv, G', a', b')."""
    half = len(a) // 2
    a_L, a_R = a[:half], a[half:]
    b_L, b_R = b[:half], b[half:]
    L = _msm_with_extras_host(G[half:], a_L, [Q, H], [HP.dot(a_L, b_R), blind_L])
    R = _msm_with_extras_host(G[:half], a_R, [Q, H], [HP.dot(a_R, b_L), blind_R])
    u, u_inv = _challenge(L, R, transcript)
    G = CH.dual_mul_many(u_inv, u, G[:half], G[half:])
    a = [(u * a_L[k] + u_inv * a_R[k]) % FR_MOD for k in range(half)]
    b = [(u_inv * b_L[k] + u * b_R[k]) % FR_MOD for k in range(half)]
    return L, R, u, u_inv, G, a, b


def _challenge(L: GroupElem, R: GroupElem, transcript):
    L.append_to_transcript(b"L", transcript)
    R.append_to_transcript(b"R", transcript)
    u = transcript.challenge_scalar(b"u")
    return u, fr_inv(u)


def device_extras(Q: GroupElem, H: GroupElem, blinds: list[int], device):
    """(Q, H) as affine tensors and the canonical blinds [k, 8]: a
    reduction's uploads of what every device round reads."""
    return (CU.encode_points_affine([Q.p, H.p], device),
            F.encode_canonical([x % FR_MOD for x in blinds], device))


def device_round(G, a, b, QH, blinds, transcript, gamma=None):
    """One round on the card. G affine (x, y, inf) [m], a and b [m, 8]
    Montgomery, QH from ``device_extras``, blinds [2, 8] canonical (blind_L,
    blind_R). ``gamma`` = canonical blind [8] adds Gamma's row
    <a, G> + <a, b> Q + blind H to the round's MSM. Returns (L, R, u,
    u_inv, G', a', b', Gamma or None)."""
    m = a.shape[0]
    half = m // 2
    dev = a.device
    # c_L = <a_L, b_R>, c_R = <a_R, b_L> (and <a, b>): Montgomery [k, 8]
    c = fr.reduce_sum(fr.mul(a, torch.cat((b[half:], b[:half]))).reshape(2, half, NUM_LIMBS),
                      axis=1)
    if gamma is not None:
        c = torch.cat((c, mle.k_dot(a, b).unsqueeze(0)))
    canon = fr.from_mont(torch.cat((a, c)))
    rows = 2 if gamma is None else 3
    sc = torch.zeros((rows, m + 2, NUM_LIMBS), dtype=torch.int32, device=dev)
    sc[0, half:m] = canon[:half]       # L = <a_L, G_R> + c_L Q + blind_L H
    sc[1, :half] = canon[half:m]       # R = <a_R, G_L> + c_R Q + blind_R H
    sc[:2, m] = canon[m:m + 2]
    sc[:2, m + 1] = blinds
    if gamma is not None:
        sc[2, :m] = canon[:m]
        sc[2, m] = canon[m + 2]
        sc[2, m + 1] = gamma
    pts = tuple(torch.cat((g, e)) for g, e in zip(G, QH))
    out = [GroupElem(p) for p in CU.decode_few(MSM.msm(pts, sc))]
    L, R = out[0], out[1]
    u, u_inv = _challenge(L, R, transcript)

    # [u^-1, u] canonical for the generators, [u, u^-1] Montgomery for a, b
    us = to_tensor(ints_to_limbs([u_inv, u, u * _R % FR_MOD, u_inv * _R % FR_MOD]), dev)
    x, y, inf = (t.reshape(2, half, *t.shape[1:]) for t in G)
    prods = CU.scalar_mul(us[:2].unsqueeze(1).expand(2, half, NUM_LIMBS),
                          CU.from_affine(x, y, inf))
    G = CU.batch_normalize(CU.padd(tuple(p[0] for p in prods), tuple(p[1] for p in prods)),
                           host=True)
    u_m, u_inv_m = us[2], us[3]
    a = fr.add(fr.mul(u_m, a[:half]), fr.mul(u_inv_m, a[half:]))
    b = fr.add(fr.mul(u_inv_m, b[:half]), fr.mul(u_m, b[half:]))
    return L, R, u, u_inv, G, a, b, (out[2] if gamma is not None else None)


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
        with Timer("bullet.reduce"):
            return BulletReductionProof._prove(transcript, Q, G_affine, H, a_mont, b_mont,
                                               blind, blinds_vec)

    @staticmethod
    def _prove(transcript, Q, G_affine, H, a_mont, b_mont, blind, blinds_vec):
        n = a_mont.shape[0]
        lg_n = log_2(n)
        assert len(blinds_vec) == lg_n
        assert G_affine[0].shape[0] == n
        dev = a_mont.device

        G, a, b = G_affine, a_mont, b_mont
        on_card = n > 1 and not HP.bullet_on_host(n, dev)
        Gamma = None
        tail = None   # the span of the host rounds, from their decode to the last round
        if on_card:
            QH, blinds = device_extras(Q, H, [x for pair in blinds_vec for x in pair] + [blind],
                                       dev)
        else:
            tail = Timer("bullet.host_tail")
            a, b, G = F.decode_fr(a), F.decode_fr(b), _decode_affine(G)
            Gamma = _msm_with_extras_host(G, a, [Q, H], [HP.dot(a, b), blind])
        blind_Gamma = blind % FR_MOD

        L_vec: list[GroupElem] = []
        R_vec: list[GroupElem] = []
        for i in range(lg_n):
            blind_L, blind_R = blinds_vec[i]
            if on_card and HP.bullet_on_host(n >> i, dev):
                on_card = False
                tail = Timer("bullet.host_tail")
                a, b, G = F.decode_fr(a), F.decode_fr(b), _decode_affine(G)
            if on_card:
                with Timer("bullet.device_round"):
                    L, R, u, u_inv, G, a, b, g = device_round(
                        G, a, b, QH, blinds[2 * i:2 * i + 2], transcript,
                        gamma=blinds[-1] if i == 0 else None)
                if g is not None:
                    Gamma = g
            else:
                L, R, u, u_inv, G, a, b = host_round(G, a, b, Q, H, blind_L, blind_R,
                                                     transcript)
            blind_Gamma = (u * u % FR_MOD * blind_L + blind_Gamma
                           + u_inv * u_inv % FR_MOD * blind_R) % FR_MOD
            L_vec.append(L)
            R_vec.append(R)
        if tail is not None:
            tail.stop()

        if on_card:
            a_hat, b_hat = F.decode_fr(torch.cat((a, b)))
            g_hat = GroupElem(_decode_affine(G)[0])
        else:
            a_hat, b_hat, g_hat = a[0], b[0], GroupElem(G[0])
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
