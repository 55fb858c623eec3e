"""The fused batched product sumcheck: the challenges stay on the device.

Counterpart of ``spartan_tpu/core/sumcheck_fused.py``, and the only driver
of ``SumcheckInstanceProof.prove_cubic_batched``'s unsharded rounds, on
every device. The merlin sponge lives on the device
(``ops/transcript_device.py``), so the challenge -> fold -> evaluations
recurrence never leaves it:

* each round above ``SMALL_BUCKET_N`` entries is S2's evaluations, then
  T1 (``csrc/sc_transcript.cu``: the round's cubic absorbed, r squeezed
  into the tensor the next launch reads), then S1's fold of the shared C
  and S2's fold + next evaluations, with no host read between rounds;
* at or below ``SMALL_BUCKET_N`` entries, one launch of T2
  (``csrc/sc_tail.cu``) runs every remaining round;
* one device-to-host transfer then brings back the round polynomials, the
  challenges and the final values, and the host replays every polynomial
  through its own ``Transcript`` and raises if a device challenge differs
  (as the JAX package asserts at ``sumcheck_fused.py:329``).

The JAX design (one ``lax.scan`` over bit-reversed, zero-padded, stacked
buffers, for the TPU's compile costs) is not copied: the tables stay in
natural order and the rounds above the tail are the per-round kernels.
On a CPU tensor the same driver runs the kernels' plain versions
(``round_transcript_plain``, ``prod_tail_plain``). There is no fallback: a
kernel that fails to build or launch fails the prove.
"""

from __future__ import annotations

import torch

from spartan_tpu_torch.core.unipoly import UniPoly
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import sumcheck_kernels as SK
from spartan_tpu_torch.ops import transcript_device as TD
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.ops.limbs import NUM_LIMBS

# tables of at most this many entries run their remaining rounds in T2
# (chosen on the H100 with chip_smoke.py's tail_threshold, T2 entering at
# 2^10 .. 2^14 entries on one 2^14-entry sumcheck; PERF.md)
SMALL_BUCKET_N = 1 << 14


def prove_cubic_batched_fused(claim: int, num_rounds: int, TA, TB, TC, Cp, nP: int,
                              coeffs, transcript):
    """Fused driver for SumcheckInstanceProof.prove_cubic_batched.

    TA/TB: per-instance tables (par then seq), TC: the seq instances' own
    C tables, Cp: the par instances' shared C, all [2^num_rounds, 8] on
    one device. The tables are consumed. Returns (compressed_polys, r,
    claims_prod, claims_dotp), the claims as prove_cubic_batched returns them."""
    nS = len(TC)
    I = nP + nS
    dev = Cp.device
    n = Cp.shape[0]
    assert n == 1 << num_rounds
    sponge = TD.pack_sponge(transcript, dev)
    enc = F.encode_fr([c % FR_MOD for c in coeffs] + [claim % FR_MOD], device=dev)
    coeffs_d, claim_d = enc[:I].contiguous(), enc[I].clone()
    polys_d = torch.zeros((num_rounds, 4, NUM_LIMBS), dtype=torch.int32, device=dev)
    rs_d = torch.zeros((num_rounds, NUM_LIMBS), dtype=torch.int32, device=dev)

    TA, TB, TC = list(TA), list(TB), list(TC)
    evals = None
    j = 0
    while n > SMALL_BUCKET_N:
        if evals is None:
            evals = SK.prod_evals(TA, TB, [Cp] * nP + TC)
        TD.round_transcript(evals, coeffs_d, claim_d, sponge, polys_d[j], rs_d[j])
        r = rs_d[j]
        if n // 2 > SMALL_BUCKET_N:
            (Cp,) = SK.fold([Cp], r)
            TA, TB, Cs, evals = SK.prod_step(TA, TB, [Cp] * nP + TC, r,
                                             [False] * nP + [True] * nS)
            TC = Cs[nP:]
        else:
            out = SK.fold(TA + TB + [Cp] + TC, r)
            TA, TB, Cp, TC = out[:I], out[I:2 * I], out[2 * I], out[2 * I + 1:]
            evals = None
        n //= 2
        j += 1
    finals = SK.prod_tail(TA, TB, Cp, TC, coeffs_d, claim_d, sponge, polys_d[j:], rs_d[j:])
    del TA, TB, TC, Cp

    # the one transfer: polynomials, challenges, final values
    vals = F.decode_fr(torch.cat((polys_d.reshape(-1, NUM_LIMBS), rs_d, finals)))
    polys = []
    r: list[int] = []
    for k in range(num_rounds):
        poly = UniPoly(vals[4 * k:4 * k + 4])
        poly.append_to_transcript(b"poly", transcript)
        r_k = transcript.challenge_scalar(b"challenge_nextround")
        if r_k != vals[4 * num_rounds + k]:
            raise RuntimeError(f"device transcript diverged from host at round {k}")
        r.append(r_k)
        polys.append(poly.compress())
    finals = vals[5 * num_rounds:]
    finals_A, finals_B = finals[:I], finals[I:2 * I]
    claims_prod = (finals_A[:nP], finals_B[:nP], finals[2 * I])
    claims_dotp = (finals_A[nP:], finals_B[nP:], finals[2 * I + 1:])
    return polys, r, claims_prod, claims_dotp
