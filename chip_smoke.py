#!/usr/bin/env python3
"""Smoke test of the spartan_tpu_torch port on one CUDA card.

    python3 chip_smoke.py            # what a checkout's proof of life runs

Phases, each printing one JSON line (``"phase": ...``):

1. device   the card's name and power limit (``nvidia-smi``);
2. build    the four CUDA kernels built from ``spartan_tpu_torch/csrc``
            with nvcc for sm_90a, one nvcc per source, in parallel;
3. kernels  each kernel against its plain PyTorch version on the card at
            the NIZK's shapes, bit for bit (tolerance 0: all arithmetic is
            exact mod p), and the MSM against the host C MSM;
4. nizk     NIZK.prove / verify of a synthetic 2^20-constraint instance on
            the card, with per-phase times, every kernel's launch count in
            the prove, and a corrupted proof rejected;
5. cross    at 2^10, with the host-path thresholds lowered so the device
            paths run, the proof made on the card equals the CPU one.

Then the ``kernels`` summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any mismatch or exception exits
non-zero. Without CUDA, or without the package beside this file, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet / CUDA C++ Programming Guide throughput
# table for compute capability 9.0): 3.35 TB/s of HBM3; 64 32-bit integer
# multiplies per clock per SM x 132 SMs x 1.98 GHz boost.
HBM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_S = 132 * 64 * 1.98e9
# 32-bit multiplies in one 8-limb CIOS Montgomery product: per outer word,
# 8 wide products a*b_i (lo + hi = 16), 1 for m, 8 wide products m*p (16)
MONT = 8 * (16 + 1 + 16)
PADD_M, PADD_MIXED_M, PDBL_M = 12, 11, 8   # Montgomery products per formula

FIELD_N = 1 << 20    # H1 check: the largest table the sumchecks fold
POINTS_N = 1 << 16   # H2 check
NIZK_LOG2 = 20       # constraints = variables, the keyless scale of bench_e2e_20.json;
                     # its witness commit (H3/H4's shape) is 2^10 rows x 2^10 + 1 points
CROSS_LOG2 = 10      # card-vs-CPU proof comparison

SOURCES = {
    "field_ew": ("spartan_tpu_torch/csrc/field_ew.cu",
                 "spartan_tpu/ops/pallas_field.py:469 (mul_kernel; add_kernel :472, "
                 "sub_kernel :475)"),
    "curve_ew": ("spartan_tpu_torch/csrc/curve_ew.cu",
                 "spartan_tpu/ops/pallas_field.py:507 (padd_kernel; pdbl_kernel :514)"),
    "msm_bucket": ("spartan_tpu_torch/csrc/msm_bucket.cu",
                   "spartan_tpu/ops/msm_pallas.py:65 (_prefix_kernel)"),
    "msm_weighted": ("spartan_tpu_torch/csrc/msm_weighted.cu",
                     "spartan_tpu/ops/msm_pallas.py:114 (_weighted_kernel)"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, nmuls: float) -> tuple[float, str]:
    """Least time in ms for the work: bytes at the HBM rate vs 32-bit
    multiplies at the integer multiply rate, whichever is longer."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nmuls / INT32_MULS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "spartan_tpu_torch")):
        print("chip_smoke: spartan_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from spartan_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})

    t = time.perf_counter()
    took = K.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t, "per_source_s": took})

    report = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": None, "max_abs_err": None, "match": None, "ms": None,
                     "plain_ms": None, "bound_ms": None, "bound_by": None,
                     "library_ms": None}
              for name, (src, rep) in SOURCES.items()}
    check_kernels(torch, dev, report)
    counts = run_nizk(torch, NIZK_LOG2)
    for name, n in counts.items():
        report[name]["launches"] = n
    run_cross(torch, CROSS_LOG2)

    emit({"kernels": list(report.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms of ``reps`` calls after one warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def launch_ms(torch, name: str, launch, launches: int = 300, repeats: int = 5) -> dict:
    """Per-launch ms of a raw C launch on operands allocated and checked
    once, so that no wrapper work (checks, allocation) is timed: the median
    over ``repeats`` windows of ``launches`` back-to-back launches, with
    the windows' spread."""
    from spartan_tpu_torch.ops import kernels as K

    K.check(launch(), name)
    torch.cuda.synchronize()
    per = []
    for _ in range(repeats):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        rc = 0
        s.record()
        for _ in range(launches):
            rc |= launch()
        e.record()
        torch.cuda.synchronize()
        K.check(rc, name)
        per.append(s.elapsed_time(e) / launches)
    per.sort()
    return {"ms": per[len(per) // 2], "min_ms": per[0], "max_ms": per[-1]}


def cuda_once(torch, fn):
    """(result, ms) of one call, timed with CUDA events."""
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def diff(torch, a, b) -> int:
    """Max |a - b| over the limbs' bit patterns (0 iff identical)."""
    if isinstance(a, tuple):
        return max(diff(torch, x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def rand_canon(torch, spec, n: int, gen) -> "torch.Tensor":
    """n random canonical field elements (top limb below p's), plus the
    edge values 0, 1, p - 1 in the first rows."""
    import numpy as np

    from spartan_tpu_torch.ops.limbs import to_tensor

    dev = gen.device
    limbs = torch.randint(-(1 << 31), 1 << 31, (n, 8), dtype=torch.int64,
                          device=dev, generator=gen)
    limbs[:, 7] = torch.randint(0, int(spec.p_limbs[7]), (n,), device=dev, generator=gen)
    out = limbs.to(torch.int32)
    pm1 = spec.p_limbs.copy()
    pm1[0] -= 1
    edges = np.asarray([[0] * 8, [1] + [0] * 7, pm1], dtype=np.uint32)
    out[:3] = to_tensor(edges, dev)
    return out


def check_kernels(torch, dev, report) -> None:
    from spartan_tpu_torch.ops import curve as CU
    from spartan_tpu_torch.ops import curve_host as CH
    from spartan_tpu_torch.ops import field as F
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.ops import msm as M
    from spartan_tpu_torch.ops.fields_host import FR_MOD

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    stream = K.stream(dev)

    # -- H1: Fr/Fq mul/add/sub at 2^20, and a scalar-broadcast mul ---------
    n = FIELD_N
    h1 = {"max_abs_err": 0, "detail": {}}
    lib = K.lib("field_ew")
    for spec in (F.FR, F.FQ):
        a, b = rand_canon(torch, spec, n, gen), rand_canon(torch, spec, n, gen)
        for op in ("mul", "add", "sub"):
            k = F.field_ew(op, spec, a, b)
            p = F.field_ew_plain(op, spec, a, b)
            err = diff(torch, k, p)
            h1["max_abs_err"] = max(h1["max_abs_err"], err)
            args = (F._OP_CODE[op], spec.code, a.data_ptr(), 1, b.data_ptr(), 1,
                    k.data_ptr(), n, stream)
            timed = launch_ms(torch, "field_ew", lambda: lib.field_ew_launch(*args))
            pms = cuda_ms(torch, lambda: F.field_ew_plain(op, spec, a, b), 2)
            op_bound, _ = bound(96 * n, MONT * n if op == "mul" else 0)
            h1["detail"][f"{spec.name}.{op}"] = {**timed, "plain_ms": pms,
                                                 "bound_ms": op_bound, "err": err}
            if err:
                raise AssertionError(f"H1 {spec.name}.{op}: kernel != plain ({err})")
        s = a[5]
        err = diff(torch, F.field_ew("mul", spec, s, b), F.field_ew_plain("mul", spec, s, b))
        h1["detail"][f"{spec.name}.mul_scalar_broadcast.err"] = err
        if err:
            raise AssertionError(f"H1 {spec.name} scalar broadcast: kernel != plain")
    main_op = h1["detail"]["Fr.mul"]
    bms, by = bound(96 * n, MONT * n)
    report["field_ew"].update(max_abs_err=h1["max_abs_err"], match=True, ms=main_op["ms"],
                              ms_spread=[main_op["min_ms"], main_op["max_ms"]],
                              plain_ms=main_op["plain_ms"], bound_ms=bms, bound_by=by,
                              shape=f"Fr mul, {n} elements", detail=h1["detail"])
    emit({"phase": "kernels", "kernel": "field_ew", **report["field_ew"]})

    # -- H2: padd/pdbl at 2^16 points, with identities, doublings, P + (-P)
    npts = POINTS_N
    base = [CH.scalar_mul(s, CH.GEN) for s in range(1, 257)]
    bx, by_, _ = CU.encode_points_affine(base, dev)
    pick = lambda: torch.randint(0, 256, (npts,), device=dev, generator=gen)
    ia, ib = pick(), pick()
    z1 = rand_canon(torch, F.FQ, npts, gen)
    z1[:3] = F.fq.one((3,), dev)
    z2 = rand_canon(torch, F.FQ, npts, gen)
    z2[:3] = F.fq.one((3,), dev)
    P = tuple(F.fq.mul(c, z1) for c in (bx[ia], by_[ia], F.fq.one((npts,), dev)))
    Q = tuple(F.fq.mul(c, z2) for c in (bx[ib], by_[ib], F.fq.one((npts,), dev)))
    # rows 0..1023: identities on either side; 1024..2047: P + P (another
    # projective scale); 2048..3071: P + (-P)
    Q = tuple(c.clone() for c in Q)
    P = tuple(c.clone() for c in P)
    for c in (P[0], P[2]):
        c[:512] = 0
    for c in (Q[0], Q[2]):
        c[512:1024] = 0
    r = slice(1024, 2048)
    Q[0][r], Q[1][r], Q[2][r] = (F.fq.mul(c[r], z2[r]) for c in P)
    r = slice(2048, 3072)
    Q[0][r], Q[1][r], Q[2][r] = P[0][r], F.fq.neg(P[1][r]), P[2][r]
    err_add = diff(torch, CU.padd(P, Q), CU.padd_plain(P, Q))
    err_dbl = diff(torch, CU.pdbl(P), CU.pdbl_plain(P))
    if err_add or err_dbl:
        raise AssertionError(f"H2: kernel != plain (padd {err_add}, pdbl {err_dbl})")
    got = CU.decode_points(tuple(c[1020:1030] for c in CU.padd(P, Q))) + \
        CU.decode_points(tuple(c[2040:2050] for c in CU.padd(P, Q)))
    hostP = CU.decode_points(tuple(c[1020:1030] for c in P)) + \
        CU.decode_points(tuple(c[2040:2050] for c in P))
    hostQ = CU.decode_points(tuple(c[1020:1030] for c in Q)) + \
        CU.decode_points(tuple(c[2040:2050] for c in Q))
    if got != [CH.add(x, y) for x, y in zip(hostP, hostQ)]:
        raise AssertionError("H2: padd disagrees with the host curve")
    lib = K.lib("curve_ew")
    R2 = CU.padd(P, Q)
    add_args = [c.data_ptr() for c in (*P, *Q, *R2)] + [npts, stream]
    dbl_args = [c.data_ptr() for c in (*P, *R2)] + [npts, stream]
    t_add = launch_ms(torch, "curve_ew", lambda: lib.curve_padd_launch(*add_args))
    t_dbl = launch_ms(torch, "curve_ew", lambda: lib.curve_pdbl_launch(*dbl_args))
    pms_add = cuda_ms(torch, lambda: CU.padd_plain(P, Q), 2)
    pms_dbl = cuda_ms(torch, lambda: CU.pdbl_plain(P), 2)
    bms, bby = bound(9 * 32 * npts, PADD_M * MONT * npts)
    dbms, _ = bound(6 * 32 * npts, PDBL_M * MONT * npts)
    report["curve_ew"].update(max_abs_err=0, match=True, ms=t_add["ms"],
                              ms_spread=[t_add["min_ms"], t_add["max_ms"]],
                              plain_ms=pms_add, bound_ms=bms, bound_by=bby,
                              shape=f"padd, {npts} points",
                              detail={"pdbl": t_dbl, "pdbl_plain_ms": pms_dbl,
                                      "pdbl_bound_ms": dbms})
    emit({"phase": "kernels", "kernel": "curve_ew", **report["curve_ew"]})

    # -- H3 + H4 at the 2^20 witness-commit shape: 1024 rows x 1025 points
    from spartan_tpu_torch import device as DEV
    from spartan_tpu_torch.pcs.hyrax import PolyCommitmentGens

    rows = R = 1 << (NIZK_LOG2 // 2)
    with DEV.use(dev):
        gens = PolyCommitmentGens(NIZK_LOG2, b"gens_r1cs_sat")
    pts = gens.gens.gens_n.extended_points()
    sc = rand_canon(torch, F.FR, rows * (R + 1), gen).reshape(rows, R + 1, 8)
    sc[0, :5] = 0
    c = M.choose_window(R + 1)
    digits = M.window_digits(sc, c)                                  # [rows, N, W]
    W = digits.shape[-1]
    dig = digits.permute(2, 0, 1).reshape(W * rows, R + 1).contiguous()
    args = M.bucket_inputs(pts, dig, c)
    buckets = M.launch_msm_bucket(*args)
    seglen, nseg = M._segments((1 << c) - 1)
    shares = M.launch_msm_weighted(buckets, seglen, nseg)
    plain3, pms3 = cuda_once(torch, lambda: M.bucket_sums_plain(*args))
    plain4, pms4 = cuda_once(torch, lambda: M.weighted_shares_plain(buckets, seglen, nseg))
    err3, err4 = diff(torch, buckets, plain3), diff(torch, shares, plain4)
    if err3 or err4:
        raise AssertionError(f"H3/H4: kernel != plain ({err3}, {err4})")
    del plain3, plain4
    # whole rows against the host C MSM
    out = M.msm(pts, sc)
    host_pts = gens.gens.gens_n.host_points()
    host_pts = host_pts[0] + [host_pts[1]]
    check_rows = [0, 1, rows // 2 - 1, rows - 1]
    got = CU.decode_points(tuple(a[check_rows] for a in out))
    sc_host = F.decode_fr(F.fr.to_mont(sc[check_rows].reshape(-1, 8)))
    for i, row in enumerate(check_rows):
        want = CH.msm([v % FR_MOD for v in sc_host[i * (R + 1):(i + 1) * (R + 1)]], host_pts)
        if got[i] != want:
            raise AssertionError(f"MSM row {row} disagrees with the host C MSM")
    ms3 = cuda_ms(torch, lambda: M.launch_msm_bucket(*args), 3)
    ms4 = cuda_ms(torch, lambda: M.launch_msm_weighted(buckets, seglen, nseg), 3)
    msm_ms = cuda_ms(torch, lambda: M.msm(pts, sc), 2)
    B, nb, N = dig.shape[0], (1 << c) - 1, R + 1
    # H3's function: a bucket of k points is k - 1 mixed additions
    adds = int((args[4] - args[3] - 1).clamp(min=0).sum().item())
    b3, b3by = bound(N * 64 + B * N * 4 + B * nb * 8 + B * nb * 96,
                     adds * PADD_MIXED_M * MONT)
    # H4's function, sum_b b * B_b per row, by running and total sums:
    # 2 (nb - 1) complete additions per row, one projective point out
    b4, b4by = bound(B * nb * 96 + B * 96, B * 2 * (nb - 1) * PADD_M * MONT)
    shape = f"{rows} rows x {N} points, c={c}, {B} digit rows"
    report["msm_bucket"].update(max_abs_err=0, match=True, ms=ms3, plain_ms=pms3, bound_ms=b3,
                                bound_by=b3by, shape=shape, mixed_adds=adds)
    report["msm_weighted"].update(max_abs_err=0, match=True, ms=ms4, plain_ms=pms4, bound_ms=b4,
                                  bound_by=b4by, shape=f"{B} rows x {nb} buckets, "
                                  f"{nseg} segments of {seglen}",
                                  witness_commit_msm_ms=msm_ms)
    emit({"phase": "kernels", "kernel": "msm_bucket", **report["msm_bucket"]})
    emit({"phase": "kernels", "kernel": "msm_weighted", **report["msm_weighted"]})


# ---------------------------------------------------------------------------
# the NIZK on the card
# ---------------------------------------------------------------------------

def run_nizk(torch, log2: int) -> dict:
    from spartan_tpu_torch.io.keyless_bench import synthetic
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.ops.fields_host import FR_MOD
    from spartan_tpu_torch.snark import NIZK, NIZKGens
    from spartan_tpu_torch.utils.errors import SpartanError
    from spartan_tpu_torch.utils.random_tape import RandomTape
    from spartan_tpu_torch.utils.serialization import deserialize, serialize
    from spartan_tpu_torch.utils.timer import Timer
    from spartan_tpu_torch.utils.transcript import Transcript

    t = time.perf_counter()
    inst, vars_, inputs, _ = synthetic(log2)
    setup_s = time.perf_counter() - t
    n = inst.inst.num_cons
    t = time.perf_counter()
    gens = NIZKGens(n, n, 1)
    gens_s = time.perf_counter() - t

    K.reset_counts()
    Timer.collect()
    Timer.acc_reset()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    proof = NIZK.prove(inst, vars_, inputs, gens, Transcript(b"chip_smoke"),
                       RandomTape(b"chip_smoke", seed=bytes([5]) * 32))
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t
    counts = K.counts()
    phases = [{"depth": d, "label": lbl, "s": s} for d, lbl, s in Timer.records()]
    acc = [{"label": lbl, "v": v} for lbl, v in Timer.acc_records()]
    Timer.collect(False)
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the prove: {missing}")

    raw = serialize(proof)
    t = time.perf_counter()
    proof.verify(inst, inputs, Transcript(b"chip_smoke"), gens)
    verify_s = time.perf_counter() - t

    bad = deserialize(NIZK, raw)
    bad.r = (bad.r[0], [(bad.r[1][0] + 1) % FR_MOD] + bad.r[1][1:])
    try:
        bad.verify(inst, inputs, Transcript(b"chip_smoke"), gens)
    except (SpartanError, AssertionError):
        rejected = True
    else:
        rejected = False
    if not rejected:
        raise AssertionError("a corrupted proof was accepted")
    emit({"phase": "nizk", "log2": log2, "num_cons": n, "setup_s": setup_s,
          "gens_s": gens_s, "prove_s": prove_s, "verify_s": verify_s,
          "proof_bytes": len(raw), "proof_sha256": hashlib.sha256(raw).hexdigest(),
          "peak_device_bytes": peak, "launches": counts, "corrupted_rejected": True,
          "prove_phases": phases, "prove_acc": acc})
    return counts


def run_cross(torch, log2: int) -> None:
    """Device-path proof on the card == the same proof on the CPU."""
    from spartan_tpu_torch.core import hostpath as HP
    from spartan_tpu_torch.io.keyless_bench import synthetic
    from spartan_tpu_torch.ops import field as F
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.ops import msm as M
    from spartan_tpu_torch.snark import NIZK, NIZKGens
    from spartan_tpu_torch.utils.random_tape import RandomTape
    from spartan_tpu_torch.utils.serialization import serialize
    from spartan_tpu_torch.utils.transcript import Transcript

    saved = (HP.HOST_N, HP.HOST_MSM_N, HP.HOST_COMMIT_POINTS, M.LADDER_N, F._HOST_CONVERT_N)
    HP.HOST_N, HP.HOST_MSM_N, HP.HOST_COMMIT_POINTS, M.LADDER_N, F._HOST_CONVERT_N = \
        2, 4, 0, 4, 0
    try:
        inst, vars_, inputs, _ = synthetic(log2, seed=1)
        n = inst.inst.num_cons
        out = {}
        for device in ("cuda", "cpu"):
            K.reset_counts()
            t = time.perf_counter()
            gens = NIZKGens(n, n, 1, device=device)
            proof = NIZK.prove(inst, vars_, inputs, gens, Transcript(b"cross"),
                               RandomTape(b"cross", seed=bytes([9]) * 32))
            out[device] = (serialize(proof), time.perf_counter() - t, K.counts())
            proof.verify(inst, inputs, Transcript(b"cross"), gens)
    finally:
        HP.HOST_N, HP.HOST_MSM_N, HP.HOST_COMMIT_POINTS, M.LADDER_N, F._HOST_CONVERT_N = saved
    same = out["cuda"][0] == out["cpu"][0]
    emit({"phase": "cross", "log2": log2, "identical": same,
          "sha256": hashlib.sha256(out["cuda"][0]).hexdigest(),
          "cuda_s": out["cuda"][1], "cpu_s": out["cpu"][1],
          "cuda_launches": out["cuda"][2], "cpu_launches": out["cpu"][2]})
    if not same:
        raise AssertionError("the card's proof differs from the CPU proof")
    # the card's run went through every kernel, the CPU run through none
    if min(out["cuda"][2].values()) <= 0 or max(out["cpu"][2].values()) > 0:
        raise AssertionError(f"cross check launches: {out['cuda'][2]}, {out['cpu'][2]}")


if __name__ == "__main__":
    sys.exit(main())
