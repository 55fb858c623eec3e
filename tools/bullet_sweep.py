"""Time one bullet round on each route, at every length from 8,192 down to
8, on a CUDA card; the crossover ``hostpath.HOST_BULLET_N`` is the length
at and below which the host round wins.

Usage (on the card): python3 tools/bullet_sweep.py [--reps 5] [--out FILE]

Prints one JSON line per length with the median milliseconds of a device
round (``bullet.device_round``: the MSM of L and R, the host trip, the
generator fold and its normalisation with the product's inverse on the
host, the a/b folds), of the same round's normalisation with the inverse
on the card instead (the Fermat ladder, ``normalize_card_ms`` against
``normalize_host_ms``), and of a host round (host C MSMs and fold, the
Python folds of a and b). Then whole DotProductProofLog openings of 8,192
entries at several crossovers, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from spartan_tpu_torch import device as DEV  # noqa: E402
from spartan_tpu_torch.core import bullet as BL  # noqa: E402
from spartan_tpu_torch.core import hostpath as HP  # noqa: E402
from spartan_tpu_torch.core.group import GroupElem  # noqa: E402
from spartan_tpu_torch.core.nizk import DotProductProofLog  # noqa: E402
from spartan_tpu_torch.ops import curve as CU  # noqa: E402
from spartan_tpu_torch.ops import curve_host as CH  # noqa: E402
from spartan_tpu_torch.ops import field as F  # noqa: E402
from spartan_tpu_torch.ops.fields_host import FR_MOD  # noqa: E402
from spartan_tpu_torch.pcs.hyrax import PolyCommitmentGens  # noqa: E402
from spartan_tpu_torch.utils.random_tape import RandomTape  # noqa: E402
from spartan_tpu_torch.utils.serialization import serialize  # noqa: E402
from spartan_tpu_torch.utils.transcript import Transcript  # noqa: E402

N = 8192   # the keyless derefs and comb_ops openings


def _ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n", type=int, default=N, help="the longest length (a power of 2)")
    ap.add_argument("--out", default="build/bullet_sweep.jsonl")
    args = ap.parse_args()
    dev = torch.device("cuda")
    lines = [{"card": _card()}]
    tape = RandomTape(b"bullet_sweep", seed=bytes([1]) * 32)
    with DEV.use(dev):
        n = args.n
        gens = PolyCommitmentGens(2 * n.bit_length() - 2, b"gens_r1cs_eval").gens
        G_dev = gens.gens_n.G
        G_host = gens.gens_n.host_points()[0]
        a_all, b_all = tape.random_vector(b"a", n), tape.random_vector(b"b", n)
        a_dev, b_dev = F.encode_fr(a_all, device=dev), F.encode_fr(b_all, device=dev)
        Q = GroupElem(CH.scalar_mul(tape.random_scalar(b"q"), CH.GEN))
        H = GroupElem(CH.scalar_mul(tape.random_scalar(b"h"), CH.GEN))
        QH, blinds = BL.device_extras(Q, H, tape.random_vector(b"blinds", 2), dev)

        m = n
        while m >= 8:
            G = tuple(t[:m] for t in G_dev)
            a, b = a_dev[:m], b_dev[:m]
            BL.device_round(G, a, b, QH, blinds, Transcript(b"warm"))   # first launches
            device = _ms(lambda: BL.device_round(G, a, b, QH, blinds, Transcript(b"s")),
                         args.reps)
            half = m // 2
            proj = CU.padd(CU.from_affine(*(t[:half] for t in G)),
                           CU.from_affine(*(t[half:m] for t in G)))
            norm_host = _ms(lambda: CU.batch_normalize(proj, host=True), args.reps)
            norm_card = _ms(lambda: CU.batch_normalize(proj), args.reps)
            Gh, ah, bh = G_host[:m], a_all[:m], b_all[:m]
            host = _ms(lambda: BL.host_round(Gh, ah, bh, Q, H, 5, 7, Transcript(b"s")),
                       max(1, min(args.reps, 3 if m >= 2048 else args.reps)))
            line = {"n": m, "device_round_ms": device, "host_round_ms": host,
                    "normalize_host_ms": norm_host, "normalize_card_ms": norm_card}
            lines.append(line)
            print(json.dumps(line), flush=True)
            m //= 2

        # whole openings of n entries at several crossovers (n: all on the host)
        x = a_dev
        y = sum(p * q for p, q in zip(a_all, b_all)) % FR_MOD
        proofs = {}
        for cut in (n, 64, 32, 16, 8):
            HP.HOST_BULLET_N = cut

            def opening():
                proof, Cx, Cy = DotProductProofLog.prove(
                    gens, Transcript(b"sweep"), RandomTape(b"t", seed=bytes([2]) * 32),
                    x, 11, b_dev, y, 13)
                proofs[cut] = (serialize(proof), Cx, Cy)

            opening()
            line = {"opening_n": n, "crossover": cut, "ms": _ms(opening, 2),
                    "same_proof_as_host": proofs[cut] == proofs[n]}
            lines.append(line)
            print(json.dumps(line), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    print(json.dumps(lines[0]))


if __name__ == "__main__":
    main()
