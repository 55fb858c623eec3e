#!/usr/bin/env python3
"""Smoke test of the spartan_tpu_torch port on one CUDA card.

    python3 chip_smoke.py            # what a checkout's proof of life runs
    python3 chip_smoke.py --tail-kernels DIR
        # only T1's and T2's launch times at the prove's shapes and H4's at
        # its four (``h4_times``), for the checkout at DIR (its own
        # sources): another tree's kernels beside this one's in the same call

Phases, each printing one JSON line (``"phase": ...``):

1. device   the card's name and power limit (``nvidia-smi``);
2. build    the ten CUDA kernels built from ``spartan_tpu_torch/csrc``
            with nvcc for sm_90a, one nvcc per source, in parallel;
3. kernels  each kernel against its plain PyTorch version on the card at
            the shapes the 2^20 SNARK gives it, bit for bit (tolerance 0:
            all arithmetic is exact mod p), and the MSM against the host C
            MSM; each kernel's time beside its bound and its plain version's;
            H2's Horner ladder at the prove's two MSM shapes and its
            double-and-add;
            H3's tile, the most mixed adds one of its threads makes (at most
            the tile, however long a run); S2 also at a mid-size round;
            every kernel's registers and stack from its build, and the SASS
            of H1's Montgomery product (``cuobjdump``); T1 (the device
            transcript's round step, one warp) over a chain of 200 rounds
            at the ops trees' leaf layout and T2 (the fused sumcheck's tail,
            a thread-block cluster) at the prove's three layouts at 2^12
            and 2^14 entries and at 2 and 2^5, bit for bit against their
            plain versions (every r and the final sponge); both timed at
            every shape the prove gives them, T2 also at every cluster size,
            each with its launch configuration; and the fused driver on one
            leaf-layout sumcheck of 2^14 entries timed for each T2 entry
            size, 5 times in turns (``tail_threshold``);
   h4_times H4 timed on bucket tables of generator points at the four
            shapes the 2^20 proves give it (a KZG bucket pass of 2 x 65,535,
            a KZG MSM's 16 x 65,535 in one launch, the derefs commit's launch
            of 8,191 x 1,023, the witness commit's 37,888 x 127), each with
            its layout beside its bound, and the few-rows layout at every
            segment length at 2 and 16 rows (the same function as
            ``--tail-kernels`` runs for a parent tree);
4. kzg_msm  one single-row MSM of 2^16 points at c = 16 (H4's few-rows
            layout at 16 x 65,535 buckets) against the host C MSM;
5. nizk     NIZK.prove / verify of a synthetic 2^16-constraint instance
            (the SNARK below runs the same R1CSProof at 2^20);
6. snark    SNARKGens, SNARK.encode / prove / verify of a synthetic
            2^20-constraint instance on the card (the main path), with the
            encode and prove phase times (each MSM's stages inside them,
            as ``<phase>/msm.<stage>`` accumulators), proof bytes, peak
            device memory,
            every kernel's launch count in the prove (all ten must
            launch; T1 and T2 exactly as many times as the product trees'
            layers give, ``tail_launches``) with its summed device and
            wrapper host time, H2's, T1's and T2's launches by entry, call
            site and size, and a corrupted proof
            rejected; then the same prove again, whose proof and T1/T2
            launches must equal the first's, with both proves' times and
            ``product_layer_proof``;
7. api      the JAX package's public API through ``spartan_tpu_torch``'s
            exports, on the snark phase's instance: A, B, C rebuilt from
            their ``SparseMatEntry`` lists (3,145,728 entries in A) with
            the original's arrays and shape digest; ``get_num_*``;
            ``compute_eval_table_sparse`` of A from host lists equal to the
            device table and, on 4,096 columns, to a host bigint sum;
            ``EqPolynomial(r).evals()`` at ell = 20 equal to the host table
            (both launching H1); a SNARK with gens sized by the ``M`` views
            and VarsAssignment / InputsAssignment, proved with the snark
            phase's transcript and tape: the same commitment and proof
            bytes, verified, every kernel launched; and
            ``MultiCommitGens(4096, secure=True)`` on the card: points
            unlike the default derivation's, read back from the cache, and
            a commit through the card's MSM (H3, H4) equal to the host C
            MSM;
8. snark_kzg the same instance with the derefs committed by KZG
            (``pcs="kzg"``): the SRS of 2^25 + 2 points generated on the
            card (``srs_s`` and its phases apart from ``gens_s``), encode,
            prove (counts zeroed just before, read just after; all ten
            kernels must launch), verify (two pairings on the host), a
            corrupted KZG opening rejected, the second prove as in
            ``snark``; H4's launches exactly 3 (the witness
            commit, and each KZG MSM's 16 windows in one launch, 2 from
            ``kzg._commit_msm``); then H3, H4 and the sort timed
            on one bucket pass of its MSMs (2 digit rows of 2^25 points,
            c = 16) beside their bounds, H4 on one MSM's whole table (16 x
            65,535) against its plain version, and that MSM of 2^25 points
            at c = 14, 15, 16 (``SpartanConfig.msm_window``) in 3 turns;
9. sharded  the snark phase's instance (saved to build/smoke_sharded, not
            built again) proved by a world of 2 ranks that share the one
            card (``parallel/``; gloo, whose collectives the ranks stage
            through the host: NCCL refuses two ranks on one card), under
            Hyrax and under KZG (the SRS file of snark_kzg): encode and
            prove with ``mesh=``; every rank's commitment and proof must
            equal the single-device bytes of the snark / snark_kzg phases
            and verify; every rank's prove must launch every kernel but
            T1 (the mesh hands each product sumcheck to T2 at
            SMALL_BUCKET_N entries), T2 once per layer sumcheck, H4 as
            often as SHARDED_H4 and ``bullet_h4`` say, and take
            every mesh branch (both ZK phases' and the product layers'
            sharded tables, each 1/D of its full size, so that S2's
            largest table is 1/D of the single-device prove's; the
            sharded tree levels, the sharded bound, the row commits and,
            under KZG, the sharded MSM); each rank's times and encode and
            prove peak memory beside the single-device ones.
            Not a multi-GPU speed figure: both ranks run on one card. Then
            a world of 1 on NCCL (the only NCCL world one card allows):
            the field psum, the table gather and the MSM window gather on
            device tensors held to their local results;
10. cross   with the host-path thresholds (and the fused tail's entry size)
            lowered so the device paths run, the NIZK at 2^10 and the SNARK
            at 2^8 under Hyrax and under KZG made on the card equal the CPU
            ones (both on the fused product sumcheck, the CPU on its plain
            versions), and the card's runs launched the kernels, the CPU
            runs none;
11. ingest  tests/fixtures/multiplier2 through ``load_circom`` and
            ``keyless_bench.run`` on the card and on the CPU under either
            PCS: equal proofs; the C parser's matrices equal the Python
            parser's.

Then the ``kernels`` summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any mismatch or exception exits
non-zero. Without CUDA, or without the package beside this file, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import pickle
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
POINTS_N = 1 << 16   # H2 padd/pdbl check
SNARK_LOG2 = 20      # constraints = variables, the keyless scale of bench_e2e_20.json;
                     # its witness commit is 2^10 rows x 2^10 + 1 points
# its derefs commit: 2^12 rows x 2^13 + 1 points, of which 1024 rows are zero
# and 1280 hold one repeated value
DEREFS_ROWS, DEREFS_COLS, DEREFS_ZERO_REP = 1 << 12, 1 << 13, (1024, 1280)
# the SNARK's largest sumcheck tables at 2^20: the ops product trees have
# 2^22 leaves, so their leaf-layer round takes 12 instances of 2^21-entry
# halves plus 6 dot-product halves of 2^21; ZK phase 1 folds 2^20-entry
# tables, phase 2 2^21
SC_PROD_N, SC_PAR, SC_SEQ = 1 << 21, 12, 6
SC_ADD_N, SC_QUAD_N = 1 << 20, 1 << 21
SC_PROD_MID_N = 1 << 15  # a mid-size product round, where launches start to count
# H2's Horner ladder in the prove: commit_rows cuts the derefs commit's 4096
# rows into 5 MSMs of at most 820 rows (ROWS_BUDGET), c = 10, 26 windows;
# the witness commit is one MSM of 1024 rows, c = 7, 37 windows
HORNER_SHAPES = (("derefs commit MSM", 820, 10), ("witness commit MSM", 1 << 10, 7))
# H2's double-and-add: a bullet fold of 2^14 generators (the card's bullet
# rounds fold from 8,192 down to hostpath.HOST_BULLET_N)
SCALAR_MUL_N = 1 << 14
# H4's shapes in the 2^20 proves, (label, rows, buckets): a KZG MSM's bucket
# pass of CHUNK_BUDGET // 2^25 rows (H4's launch while it ran per chunk),
# its 16 windows in one launch, the Hyrax derefs commit's launch
# (M.CHUNK_BUDGET // 8,193 rows) and the witness commit's (1024 rows x 37
# windows)
H4_SHAPES = (("kzg pass", 2, 65535), ("kzg msm", 16, 65535),
             ("derefs launch", 8191, 1023), ("witness launch", 37888, 127))
H4_SWEEP_LG = (2, 3, 4, 5, 6)   # the few-rows layout's segments, 2^lg buckets
# H4's launches in one 2^20 prove: under Hyrax the witness commit (one
# launch) and the derefs commit's 5 MSMs of 26 x <= 820 rows, each table
# above msm.TABLE_BUDGET, so 3 chunk launches each; under KZG the witness
# commit and the two KZG MSMs (the derefs commit, the opening's quotient),
# each MSM's 16 windows in one launch (their tables of 101 MB fit
# TABLE_BUDGET; before, 8 launches of 2 rows each: 17)
H4_PROVE = {"hyrax": 16, "kzg": 3}
# and in each rank of the sharded phase: under Hyrax its row commits' 10
# chunk launches; under KZG its witness rows' one and the two MSMs of
# 2^24 + 1 points a rank, each in one launch (before, 6 of 3 rows each: 13)
SHARDED_H4 = {"hyrax": 10, "kzg": 3}
# plus, in either prove, one H4 launch for each bullet round on the card
# (its MSM has 66 to 8,194 points) and one for each such opening's Cx
# commit: the openings of the derefs (Hyrax only), comb_ops, comb_mem and
# the witness
BULLET_OPENINGS = {"hyrax": (1 << 13, 1 << 13, 1 << 11, 1 << 10),
                   "kzg": (1 << 13, 1 << 11, 1 << 10)}
KZG_SWEEP_C, KZG_SWEEP_TURNS = (14, 15, 16), 3
NIZK_LOG2 = 16       # the NIZK alone
CROSS_LOG2 = 10      # card-vs-CPU NIZK comparison
CROSS_SNARK_LOG2 = 8  # card-vs-CPU SNARK comparison, both PCS modes
KZG_MSM_N = 1 << 16  # one-row MSM at c = 16 against the host C MSM
T1_ROUNDS = 200      # T1 held to its plain version over this chain of rounds
# the fused driver on one leaf-layout sumcheck of TAIL_N entries, timed for
# each entry size of T2 (TAIL_N itself: the whole sumcheck in T2), in
# TAIL_REPEATS rounds of all sizes
TAIL_N = 1 << 14
TAIL_THRESHOLDS = (1 << 10, 1 << 11, 1 << 12, 1 << 13, 1 << 14)
TAIL_REPEATS = 5
# the product trees of the 2^20 SNARK: the ops trees' leaves (2^22, 12
# circuits, the 6 dot-product halves at the leaf layer) and the mem trees'
# (2^21, 4 circuits); a layer of 2^k entries is one batched sumcheck
OPS_TREE_LOG2, MEM_TREE_LOG2 = 22, 21
# T2 held to its plain version bit for bit: (layout, entries, shared-C
# instances, own-C instances)
T2_CHECKS = tuple((label, n, nP, nS) for n in (TAIL_N, 1 << 12) for label, nP, nS in (
    ("ops leaf", SC_PAR, SC_SEQ), ("ops above the leaf", SC_PAR, 0), ("mem trees", 4, 0))) + \
    (("ops leaf", 2, SC_PAR, SC_SEQ), ("ops leaf", 1 << 5, SC_PAR, SC_SEQ))

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
    "sc_fold": ("spartan_tpu_torch/csrc/sc_fold.cu",
                "spartan_tpu/ops/pallas_sumcheck.py:545 (_k_lm_fold)"),
    "sc_round_prod": ("spartan_tpu_torch/csrc/sc_round_prod.cu",
                      "spartan_tpu/ops/pallas_sumcheck.py:573 (_k_lm_evals_prod; _k_step_prod "
                      ":116, _k_step_prod_sharedC :140, _k_evals_prod :211)"),
    "sc_round_additive": ("spartan_tpu_torch/csrc/sc_round_additive.cu",
                          "spartan_tpu/ops/pallas_sumcheck.py:555 (_k_lm_evals_additive; "
                          "_k_step_additive :164, _k_evals_additive :227)"),
    "sc_round_quad": ("spartan_tpu_torch/csrc/sc_round_quad.cu",
                      "spartan_tpu/ops/pallas_sumcheck.py:589 (_k_lm_evals_quad; _k_step_quad "
                      ":189, _k_evals_quad :244)"),
    # no Pallas counterpart: the JAX functions they stand for
    "sc_transcript": ("spartan_tpu_torch/csrc/sc_transcript.cu",
                      "spartan_tpu/core/sumcheck_fused.py:140 (_make_round_body's "
                      "transcript step, on DynTranscript, spartan_tpu/ops/"
                      "transcript_device.py:370; not a Pallas kernel)"),
    "sc_tail": ("spartan_tpu_torch/csrc/sc_tail.cu",
                "spartan_tpu/core/sumcheck_fused.py:199 (_k_fused_cubic_batched, its "
                "while-loop over the small-table tail; not a Pallas kernel)"),
}
# ranks of the sharded phase, all on the one card
SHARDED_WORLD = 2
# kernels every rank's sharded SNARK prove must launch: all but T1, since
# the mesh hands each product sumcheck to the fused path at
# SMALL_BUCKET_N entries, where one T2 launch takes the remaining rounds
SHARDED_KERNELS = tuple(k for k in SOURCES if k != "sc_transcript")
# kernels the NIZK's prove runs (the product-layer kernel S2 is SNARK only)
NIZK_KERNELS = ("field_ew", "curve_ew", "msm_bucket", "msm_weighted", "sc_fold",
                "sc_round_additive", "sc_round_quad")


class Engaged:
    """While entered, counts the mesh branches a prove takes, with the
    full and sharded sizes of the sumcheck tables it shards, and the
    largest table S2 is launched on, by wrapping their entry points
    (restored on exit)."""

    def __enter__(self):
        import importlib

        from spartan_tpu_torch.core import sumcheck as SC
        from spartan_tpu_torch.ops import sumcheck_kernels as SK
        from spartan_tpu_torch.parallel import sumcheck_sharded as SS

        # the module (the package's attribute of this name is the function)
        MS = importlib.import_module("spartan_tpu_torch.parallel.msm_sharded")

        self.n = {k: 0 for k in ("zk_tables", "batched_tables", "tree", "bound",
                                 "commit_rows", "msm")}
        self.tables = {"zk_tables": [], "batched_tables": []}  # [full, shard] entries
        self.s2_max_entries = 0
        self._saved = []

        def table_init(key, full, shard):
            def wrap(orig):
                def init(obj, *a, **k):
                    n = full(*a)
                    orig(obj, *a, **k)
                    self.n[key] += 1
                    self.tables[key].append([n, shard(obj)])
                return init
            return wrap

        def counted(key):
            def wrap(orig):
                def fn(*a, **k):
                    self.n[key] += 1
                    return orig(*a, **k)
                return fn
            return wrap

        def s2(orig):
            def fn(A, *a, **k):
                A = list(A)
                self.s2_max_entries = max(self.s2_max_entries, A[0].shape[0])
                return orig(A, *a, **k)
            return fn

        for owner, name, wrap in (
                (SC._MeshTables, "__init__", table_init(
                    "zk_tables", lambda mesh, tables, kind: tables[0].len,
                    lambda t: t.sharded[0].shape[0])),
                (SC._BatchedMeshTables, "__init__", table_init(
                    "batched_tables", lambda mesh, TA, TB, TC, Cp, *r: Cp.shape[0],
                    lambda t: t.Cp.shape[0])),
                (SS, "make_tree_level", counted("tree")),
                (SS, "bound_sharded", counted("bound")),
                (MS, "commit_rows_sharded", counted("commit_rows")),
                (MS, "msm_sharded", counted("msm")),
                (SK, "prod_evals", s2), (SK, "prod_step", s2)):
            orig = owner.__dict__[name]
            self._saved.append((owner, name, orig))
            setattr(owner, name, wrap(orig))
        return self

    def __exit__(self, *exc):
        for owner, name, orig in self._saved:
            setattr(owner, name, orig)

    def report(self) -> dict:
        return {"engaged": dict(self.n), "sharded_tables": self.tables,
                "s2_max_entries": self.s2_max_entries}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, nmuls: float) -> tuple[float, str]:
    """Least time in ms for the work: bytes at the HBM rate vs 32-bit
    multiplies at the integer multiply rate, whichever is longer."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nmuls / INT32_MULS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if argv and (len(argv) != 2 or argv[0] != "--tail-kernels"):
        print("usage: chip_smoke.py [--tail-kernels DIR]", file=sys.stderr)
        return 2
    root = os.path.abspath(argv[1]) if argv else here
    if not os.path.isdir(os.path.join(root, "spartan_tpu_torch")):
        print(f"chip_smoke: spartan_tpu_torch/ not found in {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from spartan_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    if argv:
        # another checkout's T1, T2 and H4 (its own sources and builds), to
        # set beside this one's in the same call
        names = ("sc_transcript", "sc_tail", "msm_weighted")
        K.build_all(names)
        emit({"phase": "tail_kernels", "tree": root, "nvidia_smi": smi,
              "ptxas": {n: K.ptxas(n) for n in names}, **tail_kernel_times(torch, dev),
              "h4": h4_times(torch, dev)})
        return 0
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
    check_sumcheck_kernels(torch, dev, report)
    check_transcript_kernels(torch, dev, report)
    for name in SOURCES:
        report[name]["ptxas"] = K.ptxas(name)
    emit({"phase": "registers", "ptxas": {n: report[n]["ptxas"] for n in SOURCES}})
    h4 = h4_times(torch, dev)
    report["msm_weighted"]["detail"]["h4_times"] = h4
    emit({"phase": "h4_times", "nvidia_smi": smi, **h4})
    run_kzg_msm(torch, dev)
    run_nizk(torch, NIZK_LOG2)
    data = snark_instance(SNARK_LOG2)
    refs = {}
    counts, totals, gens, refs["hyrax"] = run_snark(torch, data, SNARK_LOG2, "hyrax")
    for name, n in counts.items():
        report[name]["launches"] = n
        report[name]["prove_device_ms"] = totals[name]["device_ms"]
    del gens
    for name, n in run_api(torch, data, refs["hyrax"], counts, smi).items():
        report[name]["api_prove_launches"] = n
    counts, totals, gens, refs["kzg"] = run_snark(torch, data, SNARK_LOG2, "kzg")
    for name, n in counts.items():
        report[name]["kzg_prove_launches"] = n
        report[name]["kzg_prove_device_ms"] = totals[name]["device_ms"]
    srs = gens.gens_r1cs_eval.gens.gens_derefs.srs
    inst_path = save_instance(data)
    del data, gens
    torch.cuda.empty_cache()
    kzg_pass(torch, dev, srs, report)
    del srs
    torch.cuda.empty_cache()
    sharded = run_sharded(torch, inst_path, refs)
    for name in SOURCES:
        report[name]["sharded_launches"] = {pcs: [r[pcs]["launches"][name] for r in sharded]
                                            for pcs in refs}
    run_nccl_world1(torch)
    run_cross(torch, CROSS_LOG2, CROSS_SNARK_LOG2)
    run_ingest(torch, here)

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
    # the SASS of the mul instantiations: one fe_mul plus the thread's index,
    # loads and stores
    h1["detail"]["sass_mul"] = {fn: v for fn, v in K.sass(K.so_path("field_ew")).items()
                                if "field_ew_kernelILi0E" in fn}
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
    detail = {"padd_2^16": {**t_add, "plain_ms": pms_add, "bound_ms": bms, "bound_by": bby},
              "pdbl_2^16": {**t_dbl, "plain_ms": pms_dbl, "bound_ms": dbms}}
    del R2

    # the Horner ladder at the prove's shapes: window sums with identities
    # and one repeated point among random multiples
    def points_like(n):
        ia = torch.randint(0, 256, (n,), device=dev, generator=gen)
        z = rand_canon(torch, F.FQ, n, gen)
        z[:3] = F.fq.one((3,), dev)
        pts = [F.fq.mul(c, z) for c in (bx[ia], by_[ia], F.fq.one((n,), dev))]
        for c in (pts[0], pts[2]):
            c[: n // 16] = 0
        return tuple(pts)

    for label, rows, c in HORNER_SHAPES:
        W = -(-254 // c)
        win = tuple(a.reshape(W, rows, 8).contiguous() for a in points_like(W * rows))
        got = CU.horner(win, c)
        want, pms = cuda_once(torch, lambda: CU.horner_plain(win, c))
        err = diff(torch, got, want)
        if err:
            raise AssertionError(f"H2 horner ({label}): kernel != plain ({err})")
        out = CU._empty_point((rows, 8), dev)
        args = [a.data_ptr() for a in win] + [W, c, rows] + [o.data_ptr() for o in out] + [stream]
        timed = launch_ms(torch, "curve_ew", lambda: lib.curve_horner_launch(*args),
                          launches=10, repeats=5)
        ops = (W - 1) * (c + 1)  # point operations in each thread's chain
        hb, hby = bound(96 * W * rows + 96 * rows,
                        rows * (W - 1) * (c * PDBL_M + PADD_M) * MONT)
        detail[f"horner, {label}"] = {
            **timed, "plain_ms": pms, "bound_ms": hb, "bound_by": hby,
            "shape": f"{rows} rows x {W} windows, c={c}", "chain_point_ops": ops,
            "us_per_chain_op": timed["ms"] * 1e3 / ops}
        del win, got, want, out

    # the double-and-add of a bullet fold round (two scalars, as there)
    n = SCALAR_MUL_N
    Pm = points_like(n)
    two = rand_canon(torch, F.FR, 8, gen)[5:7]
    sc = two[(torch.arange(n, device=dev) >= n // 2).long()].contiguous()
    sc[0] = 0
    got = CU.scalar_mul(sc, Pm)
    want, pms = cuda_once(torch, lambda: CU.scalar_mul_plain(sc, Pm))
    err = diff(torch, got, want)
    if err:
        raise AssertionError(f"H2 scalar_mul: kernel != plain ({err})")
    args = [sc.data_ptr(), 254] + [a.data_ptr() for a in Pm] + [n] + \
        [o.data_ptr() for o in got] + [stream]
    timed = launch_ms(torch, "curve_ew", lambda: lib.curve_scalar_mul_launch(*args),
                      launches=5, repeats=5)
    sb, sby = bound(32 * n + 96 * n * 2, n * 254 * (PDBL_M + PADD_M) * MONT)
    detail["scalar_mul"] = {**timed, "plain_ms": pms, "bound_ms": sb, "bound_by": sby,
                            "shape": f"{n} points, 254 bits"}
    del Pm, sc, got, want

    main = detail["horner, derefs commit MSM"]
    report["curve_ew"].update(max_abs_err=0, match=True, ms=main["ms"],
                              ms_spread=[main["min_ms"], main["max_ms"]],
                              plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                              bound_by=main["bound_by"],
                              shape=f"Horner ladder, {main['shape']} (the prove's H2 launch)",
                              detail=detail)
    emit({"phase": "kernels", "kernel": "curve_ew", **report["curve_ew"]})

    # -- H3 + H4 at the two shapes of the 2^20 SNARK prove. The witness
    # commit: 1024 rows x 1025 points, c = 7, one launch
    from spartan_tpu_torch import device as DEV
    from spartan_tpu_torch.pcs.hyrax import PolyCommitmentGens

    rows = R = 1 << (SNARK_LOG2 // 2)
    with DEV.use(dev):
        gens = PolyCommitmentGens(SNARK_LOG2, b"gens_r1cs_sat")
    pts = gens.gens.gens_n.extended_points()
    sc = rand_canon(torch, F.FR, rows * (R + 1), gen).reshape(rows, R + 1, 8)
    sc[0, :5] = 0
    c = M.choose_window(R + 1)
    digits = M.window_digits(sc, c)                                  # [rows, N, W]
    W = digits.shape[-1]
    witness = msm_launch(torch, pts, digits.permute(2, 0, 1).reshape(W * rows, R + 1), c)
    del digits
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
    witness["commit_msm_ms"] = cuda_ms(torch, lambda: M.msm(pts, sc), 2)
    del sc, gens, pts

    # the derefs commit (DEREFS_ROWS x DEREFS_COLS + a zero blind, c = 10),
    # where the prove spends most of its H3/H4 launches: one launch of
    # M.CHUNK_BUDGET // N digit rows, from rows in the derefs table's
    # proportions: zero rows, rows of one repeated value (every matrix's
    # padding entries gather eq(r)[0]) and rows of random values
    N = DEREFS_COLS + 1
    with DEV.use(dev):
        gens = PolyCommitmentGens((DEREFS_ROWS * DEREFS_COLS).bit_length() - 1, b"derefs")
    pts = gens.gens.gens_n.extended_points()
    c = M.choose_window(N)
    W = -(-254 // c)
    B = M.CHUNK_BUDGET // N
    L = -(-B // W)
    sc = rand_canon(torch, F.FR, L * N, gen).reshape(L, N, 8)
    sc[:, -1] = 0
    n_zero, n_rep = (round(L * k / DEREFS_ROWS) for k in DEREFS_ZERO_REP)
    sc[:n_zero] = 0
    sc[n_zero:n_zero + n_rep, :-1] = sc[n_zero:n_zero + n_rep, -2:-1]
    digits = M.window_digits(sc, c)
    del sc
    derefs = msm_launch(torch, pts, digits.permute(2, 0, 1).reshape(W * L, N)[:B], c)
    derefs["rows"] = {"zero": n_zero, "one_repeated_value": n_rep, "random": L - n_zero - n_rep}
    del digits, gens, pts

    for name in ("msm_bucket", "msm_weighted"):
        main, wit = derefs[name], witness[name]
        report[name].update(max_abs_err=0, match=True,
                            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                            shape=f"derefs commit launch: {main['shape']}",
                            detail={"derefs_launch": derefs, "witness_commit": wit})
        emit({"phase": "kernels", "kernel": name, **report[name]})


def msm_launch(torch, pts, dig, c: int) -> dict:
    """H3 and H4 on one launch's digit rows [B, N] against their plain
    versions, bit for bit; their times
    (mean of 3 wrapper calls; the sort before H3 too; the plain versions
    once) and bounds, H3's tile and the most mixed adds one of its threads
    made (its `walk` output, against the plain version's), and each
    kernel's registers per thread from its build."""
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.ops import msm as M

    nb = (1 << c) - 1
    B, N = dig.shape
    sort_ms = cuda_ms(torch, lambda: M.bucket_inputs(pts, dig), 3)
    args = M.bucket_inputs(pts, dig)
    walk, walk_plain = (torch.empty(B * -(-N // M.TILE), dtype=torch.int32, device=dig.device)
                        for _ in range(2))
    buckets = M.launch_msm_bucket(*args, nb, walk=walk)
    lg, ls = M.h4_layout(B, nb)
    sums = M.launch_msm_weighted(buckets, lg, ls)
    want, pms3 = cuda_once(torch, lambda: M.bucket_sums_plain(*args, nb, walk=walk_plain))
    err3 = max(diff(torch, buckets, want), diff(torch, walk, walk_plain))
    del want
    want, pms4 = cuda_once(torch, lambda: M.weighted_sums_plain(buckets, lg, ls))
    err4 = diff(torch, sums, want)
    del want
    if err3 or err4:
        raise AssertionError(f"H3/H4: kernel != plain ({err3}, {err4})")
    ms3 = cuda_ms(torch, lambda: M.launch_msm_bucket(*args, nb), 3)
    ms4 = cuda_ms(torch, lambda: M.launch_msm_weighted(buckets, lg, ls), 3)
    most = int(walk.max().item())
    if most > M.TILE - 1:
        raise AssertionError(f"H3: a thread made {most} mixed adds")
    runs = h3_runs(torch, args[3], args[4])
    # H3's function: a bucket of k points is k - 1 mixed additions
    b3, b3by = bound(N * 64 + B * N * 4 + B * nb * 8 + B * nb * 96,
                     runs["mixed_adds"] * PADD_MIXED_M * MONT)
    # H4's function, sum_b b * B_b per row, by running and total sums:
    # 2 (nb - 1) complete additions per row, one projective point out
    b4, b4by = bound(B * nb * 96 + B * 96, B * 2 * (nb - 1) * PADD_M * MONT)
    return {"msm_bucket": {"ms": ms3, "plain_ms": pms3, "bound_ms": b3, "bound_by": b3by,
                           "sort_ms": sort_ms,
                           "shape": f"{B} digit rows x {N} points, c={c}", "tile": M.TILE,
                           "max_thread_mixed_adds": most, **runs,
                           "ptxas": K.ptxas("msm_bucket")},
            "msm_weighted": {"ms": ms4, "plain_ms": pms4, "bound_ms": b4, "bound_by": b4by,
                             "share_of_bound": b4 / ms4,
                             "shape": f"{B} rows x {nb} buckets", **h4_layout_of(B, nb),
                             "ptxas": K.ptxas("msm_weighted")}}


def h4_layout_of(rows: int, nb: int) -> dict:
    """H4's layout at rows x nb: segment, lanes a group, and the levels
    [(lanes a group, groups a row, doublings)]."""
    from spartan_tpu_torch.ops import msm as M

    lg, ls = M.h4_layout(rows, nb)
    return {"segment": 1 << lg, "lanes": 1 << ls,
            "levels": [[1 << l, g, d] for l, g, d in M.h4_levels(nb, lg, ls)]}


def bucket_table_like(torch, dev, gen, rows: int, nb: int) -> tuple:
    """A [rows, nb] bucket table of generator multiples (Z = 1), every
    sixteenth bucket the identity: H4 makes the same additions on any
    values (complete formulas), so its time is that of real buckets."""
    from spartan_tpu_torch.ops import curve as CU
    from spartan_tpu_torch.ops import curve_host as CH
    from spartan_tpu_torch.ops import field as F

    bx, by_, _ = CU.encode_points_affine([CH.scalar_mul(s, CH.GEN) for s in range(1, 257)], dev)
    idx = torch.randint(0, 256, (rows * nb,), device=dev, generator=gen)
    x, y, z = bx[idx], by_[idx], F.fq.one((rows * nb,), dev)
    for c in (x, z):
        c[::16] = 0
    return tuple(a.reshape(rows, nb, 8).contiguous() for a in (x, y, z))


def h4_times(torch, dev) -> dict:
    """H4 of the package this script imported (this checkout's, or another
    checkout's under ``--tail-kernels DIR``, whose H4 may predate the
    few-rows layout) on bucket tables at H4_SHAPES: each a median of 3
    windows of wrapper calls (CUDA events), beside its bound; for this
    checkout also the few-rows layout at each segment of H4_SWEEP_LG at 2
    and 16 rows of 65,535 buckets."""
    from spartan_tpu_torch.ops import msm as M

    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    few = hasattr(M, "h4_layout")

    def ms(fn, reps):
        per = sorted(cuda_ms(torch, fn, reps) for _ in range(3))
        return {"ms": per[1], "ms_spread": [per[0], per[2]]}

    rows_out, sweep = [], []
    for label, rows, nb in H4_SHAPES:
        table = bucket_table_like(torch, dev, gen, rows, nb)
        if few:
            lg, ls = M.h4_layout(rows, nb)
            t = ms(lambda: M.launch_msm_weighted(table, lg, ls), 5)
            layout = h4_layout_of(rows, nb)
        else:
            lg = M.seglen_log2(nb)
            t = ms(lambda: M.launch_msm_weighted(table, lg), 5)
            layout = {"segment": 1 << lg, "lanes": 1 << M._lanes_log2(nb, lg)}
        b, by = bound(rows * nb * 96 + rows * 96, rows * 2 * (nb - 1) * PADD_M * MONT)
        rows_out.append({"shape": label, "rows": rows, "buckets": nb, **layout, **t,
                         "bound_ms": b, "bound_by": by, "share_of_bound": b / t["ms"]})
        if few and nb == 65535:
            for lg in H4_SWEEP_LG:
                sweep.append({"rows": rows, "segment": 1 << lg, "lanes": 32,
                              "chosen": (lg, 5) == M.h4_layout(rows, nb),
                              **ms(lambda: M.launch_msm_weighted(table, lg, 5), 5)})
        del table
    torch.cuda.empty_cache()
    return {"shapes": rows_out, "few_rows_sweep": sweep}


def h3_runs(torch, sd, start) -> dict:
    """From the sorted digit rows: the mixed adds H3's function needs and
    the longest run of one digit."""
    live = torch.arange(sd.shape[1], device=sd.device) >= start.long().unsqueeze(1)
    keys = (torch.arange(sd.shape[0], device=sd.device).unsqueeze(1) * (1 << 20) + sd)[live]
    runs = torch.unique_consecutive(keys, return_counts=True)[1]
    return {"mixed_adds": int(live.sum().item()) - runs.numel(),
            "longest_run": int(runs.max().item()) if runs.numel() else 0}


def check_sumcheck_kernels(torch, dev, report) -> None:
    """S1-S4 against their plain versions at the 2^20 SNARK's largest
    round shapes, every mode; each kernel's fused step timed as raw C
    launches on operands set up once."""
    from spartan_tpu_torch.ops import field as F
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.ops import sumcheck_kernels as SK

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    stream = K.stream(dev)
    r = rand_canon(torch, F.FR, 8, gen)[5]

    def tables(k, n):
        return [rand_canon(torch, F.FR, n, gen) for _ in range(k)]

    def check(name, got, want) -> int:
        err = max((diff(torch, a, b) for a, b in zip(_flat(got), _flat(want))), default=0)
        if err or len(_flat(got)) != len(_flat(want)):
            raise AssertionError(f"{name}: kernel != plain ({err})")
        return err

    def record(name, shape, raw, pms, nbytes, nmuls, modes):
        timed = launch_ms(torch, name, raw, launches=20, repeats=5)
        bms, by = bound(nbytes, nmuls)
        report[name].update(max_abs_err=0, match=True, ms=timed["ms"],
                            ms_spread=[timed["min_ms"], timed["max_ms"]], plain_ms=pms,
                            bound_ms=bms, bound_by=by, shape=shape, modes_checked=modes)
        emit({"phase": "kernels", "kernel": name, **report[name]})

    # -- S2: the ops trees' leaf-layer round, 12 instances on the shared
    # eq table and 6 dot-product halves with their own C
    n, nP, nS = SC_PROD_N, SC_PAR, SC_SEQ
    I = nP + nS
    A, B = tables(I, n), tables(I, n)
    Cs = tables(nS, n)
    (Cp,) = tables(1, n)
    check("sc_round_prod evals", SK.prod_evals(A, B, [Cp] * nP + Cs),
          SK.prod_evals_plain(A, B, [Cp] * nP + Cs))
    (Cpf,) = SK.fold([Cp], r)
    want, pms1 = cuda_once(torch, lambda: SK.fold_plain(Cp, r))
    check("sc_fold", [Cpf], [want])
    fold_c = [False] * nP + [True] * nS
    Cm = [Cpf] * nP + Cs
    got = SK.prod_step(A, B, Cm, r, fold_c)
    want, pms2 = cuda_once(torch, lambda: SK.prod_step_plain(A, B, Cm, r, fold_c))
    check("sc_round_prod step", got, want)
    del want
    q = n // 4
    nb = SK._nblocks(q, I)
    part = torch.empty((I, nb, 3, 8), dtype=torch.int32, device=dev)
    lib2 = K.lib("sc_round_prod")
    ptrs2 = SK._ptrs(A + B + Cm + got[0] + got[1] + got[2])
    record("sc_round_prod", f"fold + evals, {nP} instances on a shared folded C + {nS} "
           f"with their own C, {n} entries each",
           lambda: lib2.sc_round_prod_launch(1, ptrs2, I, r.data_ptr(), q, nb,
                                             part.data_ptr(), stream),
           pms2, 32 * (2 * n * I + n // 2 + nS * n + n // 2 * (2 * I + nS)),
           MONT * (nP * 5 * n // 2 + nS * 3 * n),
           ["evals only", "fold + evals, shared C", "fold + evals, own C"])
    del got, Cm, Cs, A, B
    report["sc_round_prod"]["mid_round"] = prod_round_ms(torch, dev, gen, SC_PROD_MID_N)
    emit({"phase": "kernels", "kernel": "sc_round_prod", "mid_round":
          report["sc_round_prod"]["mid_round"]})
    lib1 = K.lib("sc_fold")
    ptrs1 = SK._ptrs([Cp, Cpf])
    nb1 = SK._nblocks(n // 2, 1)
    record("sc_fold", f"one {n}-entry table (the shared eq table's fold)",
           lambda: lib1.sc_fold_launch(ptrs1, 1, r.data_ptr(), n // 2, nb1, stream),
           pms1, 48 * n, MONT * n // 2, ["fold"])
    del Cp, Cpf

    # -- S3 / S4: ZK phase 1 at 2^20 entries, phase 2 at 2^21
    for name, n, k, ne, evals, step, evals_plain, step_plain, muls in (
            ("sc_round_additive", SC_ADD_N, 4, 3, SK.additive_evals, SK.additive_step,
             SK.additive_evals_plain, SK.additive_step_plain, 7 * SC_ADD_N // 2),
            ("sc_round_quad", SC_QUAD_N, 2, 2, SK.quad_evals, SK.quad_step,
             SK.quad_evals_plain, SK.quad_step_plain, 3 * SC_QUAD_N // 2)):
        T = tables(k, n)
        check(f"{name} evals", [evals(*T)], [evals_plain(*T)])
        got = step(*T, r)
        want, pms = cuda_once(torch, lambda: step_plain(*T, r))
        check(f"{name} step", got, want)
        del want
        q = n // 4
        nb = SK._nblocks(q, 1)
        part = torch.empty((1, nb, ne, 8), dtype=torch.int32, device=dev)
        lib = K.lib(name)
        ptrs = SK._ptrs(T + list(got[:k]))
        fn = getattr(lib, f"{name}_launch")
        record(name, f"fold + evals, {k} tables of {n} entries",
               lambda: fn(1, ptrs, r.data_ptr(), q, nb, part.data_ptr(), stream),
               pms, 32 * k * n * 3 // 2, MONT * muls,
               ["evals only", "fold + evals"])
        del T, got


def check_transcript_kernels(torch, dev, report) -> None:
    """T1 over a chain of T1_ROUNDS rounds on one sponge at the ops trees'
    leaf layout (12 instances on a shared C + 6 with their own), and T2 at
    each of T2_CHECKS, against their plain versions bit for bit: every
    coefficient and r, the claim, the final 200-byte state and positions,
    T2's final values. Then both timed as raw C launches at the prove's
    shapes (``tail_kernel_times``), T2 at every cluster size it takes, and
    the T2 entry size timing (``tail_threshold_ms``)."""
    from spartan_tpu_torch.ops import field as F
    from spartan_tpu_torch.ops import sumcheck_kernels as SK
    from spartan_tpu_torch.ops import transcript_device as TD
    from spartan_tpu_torch.utils.transcript import Transcript

    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    nP, nS = SC_PAR, SC_SEQ
    I = nP + nS
    coeffs = rand_canon(torch, F.FR, I, gen)
    claim0 = rand_canon(torch, F.FR, 4, gen)[3].clone()
    tr = Transcript(b"chip_smoke t1")
    tr.append_message(b"offset", bytes(range(77)))

    # -- T1: a chain of rounds, fresh evaluations each round
    R = T1_ROUNDS
    evals = rand_canon(torch, F.FR, R * 3 * I, gen).reshape(R, 3 * I, 8)
    runs = []
    for fn in (TD.round_transcript, TD.round_transcript_plain):
        sponge, claim = TD.pack_sponge(tr, dev), claim0.clone()
        polys = torch.zeros((R, 4, 8), dtype=torch.int32, device=dev)
        rs = torch.zeros((R, 8), dtype=torch.int32, device=dev)

        def chain():
            for j in range(R):
                fn(evals[j], coeffs, claim, sponge, polys[j], rs[j])

        _, ms = cuda_once(torch, chain)
        runs.append((rs, polys, claim, sponge, ms))
    names = ("r", "coefficients", "claim", "sponge")
    for name, a, b in zip(names, runs[0], runs[1]):
        if diff(torch, a, b):
            raise AssertionError(f"sc_transcript: kernel != plain ({name}, {R} rounds)")
    st, pos, pos_begin = TD.unpack_sponge(runs[0][3])
    times = tail_kernel_times(torch, dev)
    # bytes: evals, coefficients, claim and sponge in; coefficients, r,
    # claim and sponge out. Operations: the Montgomery products (the sums
    # sum_i coeff_i e_t,i, the cubic, the serialization, the challenge's
    # reduction, the claim's update); the sponge's Keccak work has no multiplies
    bms, by = bound(32 * (4 * I + 1) + 208 + 32 * 6 + 208, MONT * (3 * I + 11))
    report["sc_transcript"].update(
        max_abs_err=0, match=True, ms=times["t1"]["ms"],
        ms_spread=[times["t1"]["min_ms"], times["t1"]["max_ms"]],
        plain_ms=runs[1][4] / R, bound_ms=bms, bound_by=by, launch="1 block x 32 threads",
        shape=f"one round of {nP} shared-C + {nS} own-C instances; chain of {R} rounds "
              f"held to the plain version",
        chain_ms_per_round=runs[0][4] / R, final_sponge={"pos": pos, "pos_begin": pos_begin,
                                                         "sha256": hashlib.sha256(st).hexdigest()},
        note="one warp, latency-bound: the bound counts multiplies only")
    emit({"phase": "kernels", "kernel": "sc_transcript", **report["sc_transcript"]})

    # -- T2 at every layout and size of T2_CHECKS
    def table(n):
        return rand_canon(torch, F.FR, max(n, 3), gen)[:n].contiguous()

    checks = []
    for label, n, nP2, nS2 in T2_CHECKS:
        I2 = nP2 + nS2
        rounds = n.bit_length() - 1
        A = [table(n) for _ in range(I2)]
        B = [table(n) for _ in range(I2)]
        Cp = table(n)
        Cs = [table(n) for _ in range(nS2)]
        co = table(I2)
        runs = []
        for fn in (SK.prod_tail, SK.prod_tail_plain):
            sponge, claim = TD.pack_sponge(tr, dev), claim0.clone()
            polys = torch.zeros((rounds, 4, 8), dtype=torch.int32, device=dev)
            rs = torch.zeros((rounds, 8), dtype=torch.int32, device=dev)
            finals, ms = cuda_once(torch, lambda: fn(A, B, Cp, Cs, co, claim, sponge, polys, rs))
            runs.append((finals, rs, polys, claim, sponge, ms))
        for name, a, b in zip(("final values",) + names, runs[0], runs[1]):
            if diff(torch, a, b):
                raise AssertionError(f"sc_tail: kernel != plain ({name}, {label}, {n} entries)")
        checks.append({"layout": f"{label} {nP2}+{nS2}", "n": n, "cluster": SK.tail_cluster(n),
                       "match": True, "plain_ms": runs[1][5]})
        del A, B, Cp, Cs, runs
    lead = next(row for row in times["t2"] if row["layout"] == "ops leaf 12+6")
    n, M = lead["n"], lead["tables"]
    report["sc_tail"].update(
        max_abs_err=0, match=True, ms=lead["ms"], ms_spread=lead["ms_spread"],
        plain_ms=checks[0]["plain_ms"], bound_ms=lead["bound_ms"], bound_by=lead["bound_by"],
        launch=f"1 cluster of {lead['cluster']} blocks x 384 threads (SC_TAIL_THREADS)",
        shape=f"{n.bit_length() - 1} rounds from {n} entries, {nP} shared-C + {nS} own-C "
              f"instances ({M} tables)",
        montgomery_products=lead["montgomery_products"], checked=checks,
        by_entry_size=times["t2"], cluster_sweep=t2_cluster_sweep(torch, dev),
        tail_threshold=tail_threshold_ms(torch, dev, gen),
        note="one cluster; each round waits on the last one's challenge")
    emit({"phase": "kernels", "kernel": "sc_tail", **report["sc_tail"]})


def t2_operands(torch, dev, gen, n: int, nP: int, nS: int) -> tuple:
    """Random stacked tables of a T2 launch and its other arguments:
    (T [M, n, 8], M, coeffs, claim, sponge, polys, rs, finals)."""
    from spartan_tpu_torch.ops import field as F
    from spartan_tpu_torch.ops import transcript_device as TD
    from spartan_tpu_torch.utils.transcript import Transcript

    I = nP + nS
    M = 2 * I + 1 + nS
    rounds = n.bit_length() - 1
    T = rand_canon(torch, F.FR, M * n, gen).reshape(M, n, 8)
    coeffs = rand_canon(torch, F.FR, max(I, 3), gen)[:I].contiguous()
    claim = rand_canon(torch, F.FR, 4, gen)[3].clone()
    sponge = TD.pack_sponge(Transcript(b"chip_smoke t2"), dev)
    polys = torch.zeros((max(rounds, 1), 4, 8), dtype=torch.int32, device=dev)
    rs = torch.zeros((max(rounds, 1), 8), dtype=torch.int32, device=dev)
    finals = torch.zeros((M, 8), dtype=torch.int32, device=dev)
    return T, M, coeffs, claim, sponge, polys, rs, finals


def t2_raw_ms(torch, dev, gen, n: int, nP: int, nS: int, last_arg: int) -> dict:
    """T2 timed as raw launches on one set of operands (each launch folds
    the same buffer again: the same work on other values). ``last_arg`` is
    the launch function's last int: the cluster size here, the thread count
    of one block in trees before the cluster."""
    from spartan_tpu_torch.ops import kernels as K

    T, M, coeffs, claim, sponge, polys, rs, finals = t2_operands(torch, dev, gen, n, nP, nS)
    lib = K.lib("sc_tail")
    rounds = n.bit_length() - 1
    timed = launch_ms(torch, "sc_tail", lambda: lib.sc_tail_launch(
        T.data_ptr(), M, n, nP + nS, nP, coeffs.data_ptr(), claim.data_ptr(), sponge.data_ptr(),
        polys.data_ptr(), rs.data_ptr(), finals.data_ptr(), rounds, last_arg, K.stream(dev)),
        launches=20, repeats=5)
    return timed


def t2_prove_shapes(small: int) -> list:
    """(layout, shared-C, own-C instances, entry sizes) of the T2 launches
    of the 2^20 prove with T2 entering at ``small`` entries: every layer
    sumcheck of 2^k entries enters at min(2^k, small)."""
    lg = small.bit_length() - 1
    return [("ops 12+0", SC_PAR, 0, [1 << k for k in range(1, lg + 1)]),
            ("ops leaf 12+6", SC_PAR, SC_SEQ, [small]),
            ("mem 4+0", 4, 0, [1 << k for k in range(1, lg + 1)])]


def tail_kernel_times(torch, dev) -> dict:
    """T1's and T2's raw launch times at the 2^20 prove's shapes, for the
    package this script imported (this checkout's, or another checkout's
    under ``--tail-kernels DIR``): T1 one leaf-layout round; T2 at every
    layout and entry size the prove gives it, at its own launch
    configuration, each beside its bound."""
    from spartan_tpu_torch.core import sumcheck_fused as SF
    from spartan_tpu_torch.ops import field as F
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.ops import sumcheck_kernels as SK
    from spartan_tpu_torch.ops import transcript_device as TD
    from spartan_tpu_torch.utils.transcript import Transcript

    gen = torch.Generator(device=dev)
    gen.manual_seed(27)
    I = SC_PAR + SC_SEQ
    evals = rand_canon(torch, F.FR, 3 * I, gen)
    coeffs = rand_canon(torch, F.FR, I, gen)
    claim = rand_canon(torch, F.FR, 4, gen)[3].clone()
    sponge = TD.pack_sponge(Transcript(b"chip_smoke t1 times"), dev)
    polys = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    r = torch.zeros(8, dtype=torch.int32, device=dev)
    lib = K.lib("sc_transcript")
    t1 = launch_ms(torch, "sc_transcript", lambda: lib.sc_transcript_launch(
        evals.data_ptr(), coeffs.data_ptr(), I, claim.data_ptr(), sponge.data_ptr(),
        polys.data_ptr(), r.data_ptr(), K.stream(dev)))
    cluster = getattr(SK, "tail_cluster", None)
    rows = []
    for layout, nP, nS, sizes in t2_prove_shapes(SF.SMALL_BUCKET_N):
        I = nP + nS
        M = 2 * I + 1 + nS
        for n in sizes:
            last = cluster(n) if cluster else SK.TAIL_THREADS
            timed = t2_raw_ms(torch, dev, gen, n, nP, nS, last)
            rounds = n.bit_length() - 1
            # the function's work: each table read once, the outputs
            # written once; per round of half size h, 6 products per
            # instance and position (the terms at t = 0, 2, 3), one per
            # table and position (the fold), and the round step's 3I + 11
            muls = sum(6 * I * (n >> (j + 1)) + M * (n >> (j + 1)) + 3 * I + 11
                       for j in range(rounds))
            bms, by = bound(32 * (M * n + I + 1) + 208 + 32 * (5 * rounds + M + 1) + 208,
                            MONT * muls)
            rows.append({"layout": layout, "n": n, "tables": M,
                         ("cluster" if cluster else "threads"): last, "ms": timed["ms"],
                         "ms_spread": [timed["min_ms"], timed["max_ms"]], "bound_ms": bms,
                         "bound_by": by, "montgomery_products": muls})
    return {"t1": t1, "t2": rows, "small_bucket_n": SF.SMALL_BUCKET_N}


def t2_cluster_sweep(torch, dev) -> list:
    """T2 at every cluster size it takes, at every entry size from 4 to
    TAIL_N for the ops layers' 12 + 0 and the mem trees' 4 + 0, and at the
    leaf layout's TAIL_N: [{layout, n, cluster, ms, chosen}]."""
    from spartan_tpu_torch.ops import sumcheck_kernels as SK

    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    rows = []
    sizes = [1 << k for k in range(2, TAIL_N.bit_length())]
    for layout, nP, nS, sizes in (("ops 12+0", SC_PAR, 0, sizes), ("mem 4+0", 4, 0, sizes),
                                  ("ops leaf 12+6", SC_PAR, SC_SEQ, [TAIL_N])):
        for n in sizes:
            nb = 1
            while nb <= SK.TAIL_MAX_CLUSTER and (nb == 1 or 2 * nb <= n):
                timed = t2_raw_ms(torch, dev, gen, n, nP, nS, nb)
                rows.append({"layout": layout, "n": n, "cluster": nb, "ms": timed["ms"],
                             "chosen": nb == SK.tail_cluster(n)})
                nb *= 2
    return rows


def tail_threshold_ms(torch, dev, gen) -> dict:
    """The fused driver on one leaf-layout batched sumcheck of TAIL_N
    entries (the rounds above the tail on S1/S2 + T1, then one T2, the one
    transfer and the host replay), for each T2 entry size in
    TAIL_THRESHOLDS, the sizes in turn within each of TAIL_REPEATS
    repetitions: every time, the median of each size, and how many
    repetitions each size was the fastest in."""
    from spartan_tpu_torch.core import sumcheck_fused as SF
    from spartan_tpu_torch.ops import field as F
    from spartan_tpu_torch.utils.transcript import Transcript

    nP, nS = SC_PAR, SC_SEQ
    I = nP + nS
    saved = SF.SMALL_BUCKET_N
    times = {str(small): [] for small in TAIL_THRESHOLDS}
    try:
        for _ in range(TAIL_REPEATS):
            for small in TAIL_THRESHOLDS:
                SF.SMALL_BUCKET_N = small
                tabs = [rand_canon(torch, F.FR, TAIL_N, gen) for _ in range(2 * I + 1 + nS)]
                torch.cuda.synchronize()
                t = time.perf_counter()
                SF.prove_cubic_batched_fused(5, TAIL_N.bit_length() - 1, tabs[:I], tabs[I:2 * I],
                                             tabs[2 * I + 1:], tabs[2 * I], nP,
                                             list(range(3, 3 + I)), Transcript(b"tail"))
                torch.cuda.synchronize()
                times[str(small)].append((time.perf_counter() - t) * 1e3)
    finally:
        SF.SMALL_BUCKET_N = saved
    median = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    wins = {k: 0 for k in times}
    for rep in range(TAIL_REPEATS):
        wins[min(times, key=lambda k: times[k][rep])] += 1
    return {"ms": times, "median_ms": median, "fastest_in_repetitions": wins,
            "fastest_median": min(median, key=median.get)}


def prod_round_ms(torch, dev, gen, n: int) -> dict:
    """S2's fold + evals step on the leaf layer's 18 instances at n entries
    each, against its plain version, timed as raw launches."""
    from spartan_tpu_torch.ops import field as F
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.ops import sumcheck_kernels as SK

    nP, nS = SC_PAR, SC_SEQ
    I = nP + nS
    A, B = ([rand_canon(torch, F.FR, n, gen) for _ in range(I)] for _ in range(2))
    Cm = [rand_canon(torch, F.FR, n // 2, gen)] * nP + \
        [rand_canon(torch, F.FR, n, gen) for _ in range(nS)]
    r = rand_canon(torch, F.FR, 8, gen)[6]
    fold_c = [False] * nP + [True] * nS
    got = SK.prod_step(A, B, Cm, r, fold_c)
    want, pms = cuda_once(torch, lambda: SK.prod_step_plain(A, B, Cm, r, fold_c))
    err = max(diff(torch, a, b) for a, b in zip(_flat(got), _flat(want)))
    if err:
        raise AssertionError(f"sc_round_prod at {n}: kernel != plain ({err})")
    q = n // 4
    nb = SK._nblocks(q, I)
    part = torch.empty((I, nb, 3, 8), dtype=torch.int32, device=dev)
    ptrs = SK._ptrs(A + B + Cm + got[0] + got[1] + got[2])
    lib = K.lib("sc_round_prod")
    timed = launch_ms(torch, "sc_round_prod",
                      lambda: lib.sc_round_prod_launch(1, ptrs, I, r.data_ptr(), q, nb,
                                                       part.data_ptr(), K.stream(dev)),
                      launches=100, repeats=5)
    wrapper = cuda_ms(torch, lambda: SK.prod_step(A, B, Cm, r, fold_c), 20)
    bms, by = bound(32 * (2 * n * I + n // 2 + nS * n + n // 2 * (2 * I + nS)),
                    MONT * (nP * 5 * n // 2 + nS * 3 * n))
    return {**timed, "wrapper_ms": wrapper, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "shape": f"fold + evals, {nP} shared-C + {nS} own-C instances, {n} entries each"}


def _flat(x) -> list:
    """Tensors of a (nested) wrapper result, Nones dropped."""
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _flat(item)]
    return [] if x is None else [x]


# ---------------------------------------------------------------------------
# the NIZK and the SNARK on the card
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
    missing = [k for k in NIZK_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the NIZK prove: {missing}")

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


def snark_instance(log2: int) -> tuple:
    """(instance, vars, inputs, nnz, seconds to build them) of the SNARK
    phases: the synthetic 2^log2 instance, built once for both paths."""
    from spartan_tpu_torch.io.keyless_bench import synthetic

    t = time.perf_counter()
    inst, vars_, inputs, nnz = synthetic(log2)
    return inst, vars_, inputs, nnz, time.perf_counter() - t


def run_snark(torch, data, log2: int, pcs: str) -> tuple:
    """A path through the SNARK on the card: SNARKGens, encode, prove,
    verify of the 2^log2 instance ``data`` with the derefs committed by
    ``pcs``: 'hyrax' (the main path) or 'kzg' (its SRS generated on the
    card at the configured path, timed apart as srs_s with its phases).
    The launch counts are zeroed just before the prove and read just after.
    Returns every kernel's launch count in the prove, its totals
    ({"launches", "device_ms", "host_ms"}: the wrapper calls' CUDA-event
    and host times, recorded while Timer collects), the gens, and the
    commitment and proof bytes with the phase times (the sharded phase's
    reference)."""
    from spartan_tpu_torch.config import SpartanConfig
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.ops.fields_host import FR_MOD
    from spartan_tpu_torch.snark import SNARK, SNARKGens
    from spartan_tpu_torch.utils.cachedir import subdir
    from spartan_tpu_torch.utils.errors import SpartanError
    from spartan_tpu_torch.utils.random_tape import RandomTape
    from spartan_tpu_torch.utils.serialization import deserialize, serialize
    from spartan_tpu_torch.utils.timer import Timer
    from spartan_tpu_torch.utils.transcript import Transcript

    inst, vars_, inputs, nnz, setup_s = data
    n = inst.inst.num_cons
    config = SpartanConfig(pcs=pcs, srs_path=os.path.join(subdir("cache", "srs"),
                                                          "smoke_snark.npz"))
    if pcs == "kzg" and os.path.exists(config.srs_path):
        os.remove(config.srs_path)   # generate it, as on a fresh machine

    def phases():
        return [{"depth": d, "label": lbl, "s": s} for d, lbl, s in Timer.records()]

    def accumulators():
        return [{"label": lbl, "v": v} for lbl, v in Timer.acc_records()]

    torch.cuda.reset_peak_memory_stats()
    Timer.collect()
    t = time.perf_counter()
    gens = SNARKGens(n, n, 1, nnz, config=config)
    torch.cuda.synchronize()
    gens_s = time.perf_counter() - t
    srs_phases = [ph for ph in phases() if ph["label"].startswith("srs.")]
    srs_s = sum(ph["s"] for ph in srs_phases)
    gens_peak = torch.cuda.max_memory_allocated()

    torch.cuda.reset_peak_memory_stats()
    Timer.collect()
    Timer.acc_reset()
    t = time.perf_counter()
    comm, decomm = SNARK.encode(inst, gens)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t
    encode_phases = phases()
    encode_acc = accumulators()
    encode_peak = torch.cuda.max_memory_allocated()

    K.reset_counts()
    Timer.collect()
    Timer.acc_reset()
    torch.cuda.reset_peak_memory_stats()
    with Engaged() as seen:
        t = time.perf_counter()
        proof = SNARK.prove(inst, comm, decomm, vars_, inputs, gens,
                            Transcript(b"chip_smoke"),
                            RandomTape(b"chip_smoke", seed=bytes([5]) * 32))
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t
    if any(seen.n.values()):
        raise AssertionError(f"the single-device {pcs} prove took a mesh branch: {seen.n}")
    counts = K.counts()
    prove_phases = phases()
    acc = accumulators()
    launches = K.timings()
    Timer.collect(False)
    totals = {name: {"launches": 0, "device_ms": 0.0, "host_ms": 0.0} for name in counts}
    for row in launches:
        t = totals[row["kernel"]]
        t["launches"] += row["launches"]
        t["device_ms"] += row["device_ms"]
        t["host_ms"] += row["host_ms"]
    if any(totals[k]["launches"] != v for k, v in counts.items()):
        raise AssertionError(f"timed launches {totals} != counted launches {counts}")
    h2 = [row for row in launches if row["kernel"] == "curve_ew"]
    tails = sorted((row for row in launches if row["kernel"] in ("sc_transcript", "sc_tail")),
                   key=lambda row: (row["kernel"], row["entry"], row["n"]))
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the {pcs} SNARK prove: {missing}")
    from spartan_tpu_torch.core import sumcheck_fused as SF

    want = tail_launches(SF.SMALL_BUCKET_N)
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{pcs}: T1/T2 launches {counts} != {want}")
    # H4: H4_PROVE launches and the bullet rounds'; under KZG each of the
    # two KZG MSMs in one
    h4_sites = {}
    for row in launches:
        if row["kernel"] == "msm_weighted":
            h4_sites[row["site"]] = h4_sites.get(row["site"], 0) + row["launches"]
    if counts["msm_weighted"] != H4_PROVE[pcs] + bullet_h4(pcs) or (
            pcs == "kzg" and h4_sites.get("kzg._commit_msm") != 2):
        raise AssertionError(f"{pcs}: H4 launches {counts['msm_weighted']} by site {h4_sites}, "
                             f"expected {H4_PROVE[pcs] + bullet_h4(pcs)}")

    raw = serialize(proof)
    t = time.perf_counter()
    Timer.collect()
    proof.verify(comm, inputs, Transcript(b"chip_smoke"), gens)
    verify_s = time.perf_counter() - t
    verify_phases = phases()
    Timer.collect(False)

    bad = deserialize(SNARK, raw, pcs=pcs)
    if pcs == "kzg":
        # the KZG opening's claimed evaluation (the pairing check fails)
        opening = bad.r1cs_eval_proof.proof.poly_eval_network_proof.proof_hash_layer \
            .proof_derefs.proof_derefs
        opening.eval = (opening.eval + 1) % FR_MOD
    else:
        a, b, c = bad.inst_evals
        bad.inst_evals = ((a + 1) % FR_MOD, b, c)
    try:
        bad.verify(comm, inputs, Transcript(b"chip_smoke"), gens)
    except (SpartanError, AssertionError):
        rejected = True
    else:
        rejected = False
    if not rejected:
        raise AssertionError(f"a corrupted {pcs} SNARK proof was accepted")

    # the same prove again: the same bytes and T1/T2 launches
    K.reset_counts()
    Timer.collect()
    torch.cuda.synchronize()
    t = time.perf_counter()
    again = SNARK.prove(inst, comm, decomm, vars_, inputs, gens, Transcript(b"chip_smoke"),
                        RandomTape(b"chip_smoke", seed=bytes([5]) * 32))
    torch.cuda.synchronize()
    again_s, again_phases, again_counts = time.perf_counter() - t, phases(), K.counts()
    Timer.collect(False)
    if serialize(again) != raw:
        raise AssertionError(f"{pcs}: the second prove's proof differs from the first one")
    del again
    if any(again_counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{pcs}: second prove's T1/T2 launches {again_counts}")

    def plp(ph):
        return sum(x["s"] for x in ph if x["label"] == "product_layer_proof")

    line = {"phase": "snark" if pcs == "hyrax" else "snark_kzg", "pcs": pcs, "log2": log2,
            "num_cons": n, "num_nz_entries": nnz, "setup_s": setup_s}
    if pcs == "kzg":
        srs = gens.gens_r1cs_eval.gens.gens_derefs.srs
        line.update(srs_s=srs_s, srs_points=srs.size, srs_phases=srs_phases,
                    srs_path=config.srs_path)
    emit({**line, "gens_s": gens_s - srs_s, "encode_s": encode_s, "prove_s": prove_s,
          "verify_s": verify_s, "proof_bytes": len(raw),
          "proof_sha256": hashlib.sha256(raw).hexdigest(),
          "gens_peak_device_bytes": gens_peak,
          "encode_peak_device_bytes": encode_peak, "prove_peak_device_bytes": peak,
          "launches": counts, "kernel_totals": totals, "h2_launches": h2,
          "h4_launches_by_site": h4_sites,
          "t1_t2_launches": tails, "t1_t2_expected": want,
          "corrupted_rejected": True,
          "again": {"prove_s": [prove_s, again_s],
                    "product_layer_proof_s": [plp(prove_phases), plp(again_phases)],
                    "same_proof": True},
          "encode_phases": encode_phases, "encode_acc": encode_acc,
          "prove_phases": prove_phases, "prove_acc": acc, "verify_phases": verify_phases})
    ref = {"comm": serialize(comm), "proof": raw, "encode_s": encode_s, "prove_s": prove_s,
           "verify_s": verify_s, "encode_peak_device_bytes": encode_peak,
           "prove_peak_device_bytes": peak, "s2_max_entries": seen.s2_max_entries,
           "srs_path": config.srs_path}
    return counts, totals, gens, ref


# ---------------------------------------------------------------------------
# the JAX package's public API, through the port's exports
# ---------------------------------------------------------------------------

API_EVAL_COLS = 4096   # columns of the eval table held to a host bigint sum
API_GENS_N = 1 << 12   # secure generators committed through the card's MSM


def run_api(torch, data, ref: dict, snark_counts: dict, smi: str) -> dict:
    """The JAX package's public API at 2^20, through ``spartan_tpu_torch``'s
    exports only (the references use the modules), on the snark phase's
    instance ``data``:

    1. A, B, C rebuilt from their ``SparseMatEntry`` lists (``list(X.M)``):
       equal arrays, ``num_entries()``, a shape holding them with the
       original's digest and ``get_num_*``;
    2. ``compute_eval_table_sparse`` of A (host lists in and out) equal to
       the decoded device table and, on API_EVAL_COLS sampled columns, to
       a host bigint sum, with H1 launched;
    3. ``EqPolynomial(r).evals()`` at ell = 20 equal to the host table,
       with H1 launched;
    4. SNARKGens sized by the ``M`` views, encode, prove and verify of the
       rebuilt instance with VarsAssignment / InputsAssignment: the snark
       phase's commitment and proof bytes (``ref``), every kernel launched
       (counts zeroed just before the prove, read just after; reported
       beside the snark phase's first prove's, ``snark_counts``);
    5. MultiCommitGens(API_GENS_N, secure=True) on the card, in a cache
       directory of its own: points unlike the default derivation's, the
       second construction read from the cache, and a commit of a random
       vector through the card's MSM (H3, H4) equal to the host C MSM.

    Returns the prove's launch counts."""
    import random

    import numpy as np

    import spartan_tpu_torch as S
    from spartan_tpu_torch.core import commitments as CM
    from spartan_tpu_torch.core import hostpath as HP
    from spartan_tpu_torch.ops import curve as CU
    from spartan_tpu_torch.ops import curve_host as CH
    from spartan_tpu_torch.ops import field as F
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.ops.fields_host import FR_MOD
    from spartan_tpu_torch.utils.cachedir import subdir
    from spartan_tpu_torch.utils.serialization import serialize

    inst, vars_, inputs, nnz, _ = data
    shape = inst.inst
    n, num_inputs = shape.num_cons, shape.num_inputs
    nx, ny = shape.A.num_vars_x, shape.A.num_vars_y
    dev = torch.device("cuda")
    rng = random.Random(20)
    seconds, checks = {}, {}
    t0 = time.perf_counter()

    # 1. the matrices from their entries
    t = time.perf_counter()
    mats = []
    for X in (shape.A, shape.B, shape.C):
        entries = list(X.M)
        if len(entries) != X.num_entries() or not isinstance(entries[0], S.SparseMatEntry):
            raise AssertionError("api: the M view's entries")
        M = S.SparseMatPolynomial(nx, ny, entries)
        del entries
        if not (np.array_equal(M.rows, X.rows) and np.array_equal(M.cols, X.cols)
                and M.vals == X.vals and M.num_entries() == X.num_entries()):
            raise AssertionError("api: a matrix rebuilt from its entries differs")
        mats.append(M)
    seconds["entries_s"] = time.perf_counter() - t
    checks["entries"] = [M.num_entries() for M in mats]
    if checks["entries"][0] != 3 * n:
        raise AssertionError(f"api: A has {checks['entries'][0]} entries, not {3 * n}")
    t = time.perf_counter()
    rebuilt = S.R1CSShape(n, n, num_inputs, [], [], [])
    rebuilt.A, rebuilt.B, rebuilt.C = mats
    inst2 = S.Instance(rebuilt)
    seconds["digest_s"] = time.perf_counter() - t
    checks["digest_equal"] = inst2.digest == inst.digest
    checks["get_num"] = [rebuilt.get_num_cons(), rebuilt.get_num_vars(),
                         rebuilt.get_num_inputs()]
    if not checks["digest_equal"] or checks["get_num"] != [n, n, num_inputs]:
        raise AssertionError(f"api: the rebuilt shape: {checks}")

    # 2. the eval table from host lists, on the card
    evals = [rng.randrange(FR_MOD) for _ in range(n)]
    A = mats[0]
    K.reset_counts()
    t = time.perf_counter()
    table = A.compute_eval_table_sparse(evals, n, 2 * n)
    seconds["eval_table_s"] = time.perf_counter() - t
    h1 = K.counts()["field_ew"]
    device_table = F.decode_fr(shape.A.compute_eval_table_sparse_device(
        F.encode_fr(evals, device=dev), 2 * n))
    cols = rng.sample(range(2 * n), API_EVAL_COLS)
    want = dict.fromkeys(cols, 0)
    for i in np.nonzero(np.isin(A.cols, cols))[0].tolist():
        c = int(A.cols[i])
        want[c] = (want[c] + evals[int(A.rows[i])] * A.vals[i]) % FR_MOD
    checks["eval_table"] = {"equal_to_device": table == device_table,
                            "equal_to_host_sum": all(table[c] == want[c] for c in cols),
                            "columns": API_EVAL_COLS, "h1_launches": h1}
    if not (table == device_table and checks["eval_table"]["equal_to_host_sum"] and h1 > 0):
        raise AssertionError(f"api: compute_eval_table_sparse: {checks['eval_table']}")
    del table, device_table, evals

    # 3. the eq table from host ints, on the card
    r = [rng.randrange(FR_MOD) for _ in range(SNARK_LOG2)]
    K.reset_counts()
    t = time.perf_counter()
    eq = S.EqPolynomial(r).evals()
    seconds["eq_evals_s"] = time.perf_counter() - t
    h1 = K.counts()["field_ew"]
    checks["eq_evals"] = {"ell": SNARK_LOG2, "equal_to_host": eq == HP.eq_evals(r),
                          "h1_launches": h1}
    if not (checks["eq_evals"]["equal_to_host"] and h1 > 0):
        raise AssertionError(f"api: EqPolynomial.evals: {checks['eq_evals']}")
    del eq

    # 4. a SNARK through the exported names
    t = time.perf_counter()
    max_nnz = max(len(inst2.inst.A.M), len(inst2.inst.B.M), len(inst2.inst.C.M))
    gens = S.SNARKGens(n, n, num_inputs, max_nnz)
    torch.cuda.synchronize()
    seconds["gens_s"] = time.perf_counter() - t
    t = time.perf_counter()
    comm, decomm = S.SNARK.encode(inst2, gens)
    torch.cuda.synchronize()
    seconds["encode_s"] = time.perf_counter() - t
    vars2 = S.VarsAssignment(vars_.assignment)
    inputs2 = S.InputsAssignment(inputs.assignment)
    K.reset_counts()
    t = time.perf_counter()
    proof = S.SNARK.prove(inst2, comm, decomm, vars2, inputs2, gens,
                          S.Transcript(b"chip_smoke"),
                          S.RandomTape(b"chip_smoke", seed=bytes([5]) * 32))
    torch.cuda.synchronize()
    seconds["prove_s"] = time.perf_counter() - t
    counts = K.counts()
    t = time.perf_counter()
    proof.verify(comm, inputs2, S.Transcript(b"chip_smoke"), gens)
    seconds["verify_s"] = time.perf_counter() - t
    raw = serialize(proof)
    checks["snark"] = {"max_nnz": max_nnz, "verified": True,
                       "commitment_equal": serialize(comm) == ref["comm"],
                       "proof_sha256": hashlib.sha256(raw).hexdigest(),
                       "snark_phase_sha256": hashlib.sha256(ref["proof"]).hexdigest(),
                       "launches": counts,
                       "launches_equal_snark_phase": counts == snark_counts}
    missing = [k for k, v in counts.items() if v <= 0]
    if raw != ref["proof"] or not checks["snark"]["commitment_equal"] or missing:
        raise AssertionError(f"api: the SNARK through the exports: {checks['snark']}, "
                             f"kernels not launched {missing}")
    del proof, comm, decomm, gens, inst2, rebuilt, mats, A
    torch.cuda.empty_cache()

    # 5. secure generators, in a cache directory of their own
    import shutil

    label = b"chip_smoke secure"
    cache = subdir("cache", "smoke_secure_gens")
    shutil.rmtree(cache)
    os.makedirs(cache)
    derived = []
    saved_dir, saved_derive = CM._gens_cache_dir, CM.MultiCommitGens.__dict__["_derive_secure"]

    def derive(lbl, count):
        derived.append(count)
        return saved_derive.__func__(lbl, count)

    CM._gens_cache_dir = lambda: cache
    CM.MultiCommitGens._derive_secure = staticmethod(derive)
    try:
        t = time.perf_counter()
        secure = S.MultiCommitGens(API_GENS_N, label, secure=True)
        torch.cuda.synchronize()
        seconds["secure_gens_s"] = time.perf_counter() - t
        t = time.perf_counter()
        again = S.MultiCommitGens(API_GENS_N, label, secure=True)
        torch.cuda.synchronize()
        seconds["secure_gens_cached_s"] = time.perf_counter() - t
        default = S.MultiCommitGens(API_GENS_N, label)
    finally:
        CM._gens_cache_dir = saved_dir
        CM.MultiCommitGens._derive_secure = saved_derive
    same_again = all(torch.equal(a, b) for a, b in zip(secure.G + secure.h, again.G + again.h))
    unlike = bool((secure.G[0] != default.G[0]).any(dim=1).all()) and \
        not torch.equal(secure.h[0], default.h[0])
    values = [rng.randrange(FR_MOD) for _ in range(API_GENS_N)]
    blind = rng.randrange(FR_MOD)
    K.reset_counts()
    got, msm_ms = cuda_once(torch, lambda: CM.commit_device(
        F.encode_fr(values, device=dev), F.encode_fr([blind], device=dev)[0], secure))
    msm_counts = K.counts()
    got = CU.decode_points(tuple(a.unsqueeze(0) for a in got))[0]
    if CH._native() is None:
        raise AssertionError("api: the host C MSM (native/g1_host.c) is not built")
    Gs, h = secure.host_points()
    t = time.perf_counter()
    want_pt = CH.msm(values + [blind], Gs + [h])
    seconds["host_c_msm_s"] = time.perf_counter() - t
    checks["secure_gens"] = {
        "n": API_GENS_N, "derivations": derived, "cache_files": len(os.listdir(cache)),
        "second_read_from_cache": derived == [API_GENS_N + 1] and same_again,
        "unlike_default": unlike, "commit_equal_to_host_c_msm": got == want_pt,
        "msm_ms": msm_ms, "h3_launches": msm_counts["msm_bucket"],
        "h4_launches": msm_counts["msm_weighted"]}
    if not (checks["secure_gens"]["second_read_from_cache"] and unlike and got == want_pt
            and msm_counts["msm_bucket"] > 0 and msm_counts["msm_weighted"] > 0):
        raise AssertionError(f"api: secure generators: {checks['secure_gens']}")
    shutil.rmtree(cache)

    emit({"phase": "api", "log2": SNARK_LOG2, "nvidia_smi": smi,
          "seconds": {**seconds, "total_s": time.perf_counter() - t0}, "checks": checks})
    return counts


# ---------------------------------------------------------------------------
# sharded proving
# ---------------------------------------------------------------------------

def save_instance(data) -> str:
    """Pickle the SNARK phases' instance for the sharded phase's ranks
    (building it again would take most of a minute a rank)."""
    from spartan_tpu_torch.utils.cachedir import subdir

    inst, vars_, inputs, nnz, _ = data
    for m in (inst.inst.A, inst.inst.B, inst.inst.C):
        m.release_device()
    path = os.path.join(subdir("smoke_sharded"), "instance.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump((inst, vars_, inputs, nnz), f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(path + ".part", path)
    return path


def sharded_rank(mesh, inst_path: str, srs_paths: dict) -> dict:
    """One rank of the sharded phase: encode, prove and verify the instance
    at ``inst_path`` with ``mesh=`` under each PCS. The launch counts and
    the peak memory are zeroed just before each prove and read just after
    (the encode's peak apart); ``Engaged`` records the mesh branches the
    encode and the prove take."""
    import torch

    from spartan_tpu_torch.config import SpartanConfig
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.snark import SNARK, SNARKGens
    from spartan_tpu_torch.utils.random_tape import RandomTape
    from spartan_tpu_torch.utils.serialization import serialize
    from spartan_tpu_torch.utils.transcript import Transcript

    dev = mesh.device
    t = time.perf_counter()
    with open(inst_path, "rb") as f:
        inst, vars_, inputs, nnz = pickle.load(f)
    out = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend,
           "load_s": time.perf_counter() - t}
    n = inst.inst.num_cons
    for pcs, srs_path in srs_paths.items():
        t = time.perf_counter()
        gens = SNARKGens(n, n, 1, nnz, config=SpartanConfig(pcs=pcs, srs_path=srs_path),
                         device=dev)
        torch.cuda.synchronize(dev)
        gens_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats(dev)
        with Engaged() as seen:
            t = time.perf_counter()
            comm, decomm = SNARK.encode(inst, gens, mesh=mesh)
            torch.cuda.synchronize(dev)
            encode_s = time.perf_counter() - t
            encode_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            K.reset_counts()
            t = time.perf_counter()
            proof = SNARK.prove(inst, comm, decomm, vars_, inputs, gens,
                                Transcript(b"chip_smoke"),
                                RandomTape(b"chip_smoke", seed=bytes([5]) * 32), mesh=mesh)
            torch.cuda.synchronize(dev)
            prove_s = time.perf_counter() - t
            counts = K.counts()
            peak = torch.cuda.max_memory_allocated(dev)
        t = time.perf_counter()
        proof.verify(comm, inputs, Transcript(b"chip_smoke"), gens)
        out[pcs] = {"comm": serialize(comm), "proof": serialize(proof), "gens_s": gens_s,
                    "encode_s": encode_s, "prove_s": prove_s,
                    "verify_s": time.perf_counter() - t, "encode_peak_device_bytes": encode_peak,
                    "peak_device_bytes": peak, "launches": counts, **seen.report()}
        del gens, comm, decomm, proof
        torch.cuda.empty_cache()
    return out


def bullet_h4(pcs: str) -> int:
    """H4 launches of a 2^20 prove's bullet reductions at HOST_BULLET_N:
    lg n - lg HOST_BULLET_N rounds and one Cx commit per opening."""
    from spartan_tpu_torch.core import hostpath as HP

    cut = HP.HOST_BULLET_N.bit_length() - 1
    return sum(n.bit_length() - cut for n in BULLET_OPENINGS[pcs] if n > HP.HOST_BULLET_N)


def run_sharded(torch, inst_path: str, refs: dict) -> list:
    """The sharded phase: SHARDED_WORLD ranks on the card prove the snark
    phases' instance under both PCS; every rank's bytes must equal the
    single-device ones of ``refs``, every rank must launch SHARDED_KERNELS
    (T1 never, T2 once a layer sumcheck) and take every mesh branch
    (``mesh_engaged``)."""
    from spartan_tpu_torch.core import sumcheck_fused as SF
    from spartan_tpu_torch.parallel.launch import spawn

    t = time.perf_counter()
    ranks = spawn(sharded_rank, SHARDED_WORLD, inst_path,
                  {pcs: ref["srs_path"] for pcs, ref in refs.items()}, device="cuda")
    wall_s = time.perf_counter() - t
    want_t2 = tail_launches(SF.SMALL_BUCKET_N)["sc_tail"]
    line = {"phase": "sharded", "world": SHARDED_WORLD, "log2": SNARK_LOG2,
            "backend": ranks[0]["backend"], "devices": [r["device"] for r in ranks],
            "note": f"{SHARDED_WORLD} ranks share one card (gloo, host-staged collectives): "
                    "a correctness run of the sharded path, not a multi-GPU speed figure",
            "spawn_to_join_s": wall_s, "load_s": [r["load_s"] for r in ranks],
            "expected_kernels": list(SHARDED_KERNELS), "expected_t2": want_t2,
            "expected_h4": {pcs: SHARDED_H4[pcs] + bullet_h4(pcs) for pcs in SHARDED_H4}}
    failures = []
    for pcs, ref in refs.items():
        same = all(r[pcs]["comm"] == ref["comm"] and r[pcs]["proof"] == ref["proof"]
                   for r in ranks)
        launched = all(min(r[pcs]["launches"][k] for k in SHARDED_KERNELS) > 0
                       and r[pcs]["launches"]["sc_transcript"] == 0
                       and r[pcs]["launches"]["sc_tail"] == want_t2
                       and r[pcs]["launches"]["msm_weighted"] == SHARDED_H4[pcs] + bullet_h4(pcs)
                       for r in ranks)
        engaged = [mesh_engaged(r[pcs], pcs, ref["s2_max_entries"]) for r in ranks]
        line[pcs] = {
            "identical": same, "kernels_launched": launched,
            "mesh_engaged": not any(engaged),
            "proof_bytes": len(ref["proof"]),
            "proof_sha256": hashlib.sha256(ref["proof"]).hexdigest(),
            "sharded_gens_s": [r[pcs]["gens_s"] for r in ranks],
            "sharded_encode_s": [r[pcs]["encode_s"] for r in ranks],
            "sharded_prove_s": [r[pcs]["prove_s"] for r in ranks],
            "sharded_verify_s": [r[pcs]["verify_s"] for r in ranks],
            "sharded_encode_peak_device_bytes": [r[pcs]["encode_peak_device_bytes"]
                                                 for r in ranks],
            "sharded_prove_peak_device_bytes": [r[pcs]["peak_device_bytes"] for r in ranks],
            "single_device_encode_s": ref["encode_s"], "single_device_prove_s": ref["prove_s"],
            "single_device_encode_peak_device_bytes": ref["encode_peak_device_bytes"],
            "single_device_prove_peak_device_bytes": ref["prove_peak_device_bytes"],
            "single_device_s2_max_entries": ref["s2_max_entries"],
            "launches": [r[pcs]["launches"] for r in ranks],
            "engaged": [{k: r[pcs][k] for k in ("engaged", "sharded_tables", "s2_max_entries")}
                        for r in ranks]}
        if not same:
            failures.append(f"{pcs}: a rank's commitment or proof differs from the "
                            "single-device bytes")
        if not launched:
            failures.append(f"{pcs}: launches {line[pcs]['launches']}")
        failures += [f"{pcs} rank {r}: {msg}" for r, msgs in enumerate(engaged) for msg in msgs]
    emit(line)
    if failures:
        raise AssertionError("sharded: " + "; ".join(failures))
    return ranks


def mesh_engaged(rank: dict, pcs: str, single_s2: int) -> list:
    """What a rank's sharded encode and prove failed to shard (empty if
    nothing): both ZK phases' tables, the product layers' tables (each
    shard 1/D of its table, and S2's largest table 1/D of the
    single-device prove's), the tree levels, the bound, the row commits
    and, under KZG, the MSMs."""
    n, tables = rank["engaged"], rank["sharded_tables"]
    msgs = []
    if n["zk_tables"] != 2:
        msgs.append(f"ZK phases sharded {n['zk_tables']} times, not 2")
    for key in ("batched_tables", "tree", "bound", "commit_rows") + (
            ("msm",) if pcs == "kzg" else ()):
        if n[key] == 0:
            msgs.append(f"{key} never sharded")
    for key, sizes in tables.items():
        bad = [fs for fs in sizes if fs[1] * SHARDED_WORLD != fs[0]]
        if bad:
            msgs.append(f"{key}: [full, shard] entries {bad} are not 1/{SHARDED_WORLD}")
    if rank["s2_max_entries"] * SHARDED_WORLD != single_s2:
        msgs.append(f"S2's largest table {rank['s2_max_entries']} is not 1/{SHARDED_WORLD} "
                    f"of the single-device prove's {single_s2}")
    return msgs


def nccl_rank(mesh) -> dict:
    """A world of 1 on NCCL: psum_field, gather_table and msm_sharded's
    window gather on device tensors against their local results."""
    import torch

    from spartan_tpu_torch import device as DEV
    from spartan_tpu_torch.core import commitments as CM
    from spartan_tpu_torch.ops import curve as CU
    from spartan_tpu_torch.ops import field as F
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.ops import msm as M
    from spartan_tpu_torch.parallel import gather_table, msm_sharded, psum_field

    dev = mesh.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    with DEV.use(dev):
        x = rand_canon(torch, F.FR, 1 << 12, gen)
        pts = CM.points_from_scalars(rand_canon(torch, F.FR, 1 << 12, gen), dev)
        sc = rand_canon(torch, F.FR, 1 << 12, gen)
        want = CU.decode_points(tuple(a.unsqueeze(0) for a in M.msm(pts, sc)))[0]
        K.reset_counts()
        out = {"backend": mesh.backend, "size": mesh.size, "device": str(dev),
               "psum_equal": bool(torch.equal(psum_field(mesh, x), x)),
               "gather_equal": bool(torch.equal(gather_table(mesh, x), x)),
               "msm_equal": CU.decode_points(tuple(a.unsqueeze(0) for a in msm_sharded(
                   mesh, pts, sc)))[0] == want}
        out["launches"] = K.counts()
    return out


def run_nccl_world1(torch) -> None:
    from spartan_tpu_torch.parallel.launch import spawn

    t = time.perf_counter()
    (r,) = spawn(nccl_rank, 1, device="cuda", backend="nccl")
    # H4 once: msm_sharded's windows of 2^12 points in one launch (counted
    # after the reference msm)
    ok = r["psum_equal"] and r["gather_equal"] and r["msm_equal"] and \
        min(r["launches"][k] for k in ("msm_bucket", "curve_ew")) > 0 and \
        r["launches"]["msm_weighted"] == 1
    emit({"phase": "nccl_world1", **r, "ok": ok, "s": time.perf_counter() - t,
          "note": "NCCL takes one rank per card: on one card it runs only as a world of 1"})
    if not ok:
        raise AssertionError(f"nccl_world1: {r}")


def tail_launches(small: int) -> dict:
    """T1's and T2's launches in one 2^20 prove with T2 entering at
    ``small`` entries: one T2 for each layer sumcheck of the product trees
    (2^1 .. 2^(leaves - 1) entries) and one T1 for each of their rounds
    above ``small``."""
    lg = small.bit_length() - 1
    layers = list(range(1, OPS_TREE_LOG2)) + list(range(1, MEM_TREE_LOG2))
    return {"sc_transcript": sum(max(0, k - lg) for k in layers), "sc_tail": len(layers)}


def kzg_pass(torch, dev, srs, report) -> None:
    """H3, H4 and the sort on one bucket pass of the KZG prove's MSMs at
    2^20 (the derefs table of 6 x 2^22 entries padded to 2^25: 2 digit rows
    of 2^25 SRS points, c = 16), the table's values in its proportions (a
    quarter zero padding; in each matrix's quarter, its 2^20 padding
    entries one repeated value), held bit for bit against their plain
    versions and timed beside their bounds. Then the MSM's whole bucket
    table (16 windows, filled by H3 in passes of CHUNK_BUDGET // 2^25 rows,
    as ``msm.window_sums`` does) through H4 in one launch, against H4's
    plain version bit for bit; and the MSM itself at each c of KZG_SWEEP_C
    (``SpartanConfig.msm_window``), KZG_SWEEP_TURNS turns of all, equal
    affine points."""
    from spartan_tpu_torch import config
    from spartan_tpu_torch.ops import curve as CU
    from spartan_tpu_torch.ops import field as F
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.ops import msm as M

    N = 1 << (SNARK_LOG2 + 5)
    per, nnz = 1 << (SNARK_LOG2 + 2), 3 << SNARK_LOG2
    c = M.choose_window(N)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    sc = rand_canon(torch, F.FR, N, gen)
    for k in range(6):
        sc[k * per + nnz:(k + 1) * per] = sc[k * per]
    sc[6 * per:] = 0
    dig = M.window_digits(sc, c).t().contiguous()      # [W, N]
    B = M.CHUNK_BUDGET // N
    pts = tuple(a[:N] for a in srs.powers_g1)
    one = msm_launch(torch, pts, dig[:B], c)
    for name in ("msm_bucket", "msm_weighted"):
        report[name]["detail"]["kzg_pass"] = one[name]
        emit({"phase": "kernels", "kernel": name, "kzg_pass": one[name]})

    # the MSM's whole table in one H4 launch
    W, nb = dig.shape[0], (1 << c) - 1
    table = tuple(torch.empty((W, nb, 8), dtype=torch.int32, device=dev) for _ in range(3))
    for s in range(0, W, B):
        M.bucket_sums(pts, dig[s:s + B], c, out=tuple(t[s:s + B] for t in table))
    del dig
    lg, ls = M.h4_layout(W, nb)
    got = M.launch_msm_weighted(table, lg, ls)
    want, pms = cuda_once(torch, lambda: M.weighted_sums_plain(table, lg, ls))
    err = diff(torch, got, want)
    if err:
        raise AssertionError(f"H4 at {W} x {nb}: kernel != plain ({err})")
    per_ms = sorted(cuda_ms(torch, lambda: M.launch_msm_weighted(table, lg, ls), 5)
                    for _ in range(3))
    b, by = bound(W * nb * 96 + W * 96, W * 2 * (nb - 1) * PADD_M * MONT)
    whole = {"shape": f"{W} rows x {nb} buckets (one KZG MSM's windows, one launch)",
             **h4_layout_of(W, nb), "ms": per_ms[1], "ms_spread": [per_ms[0], per_ms[2]],
             "plain_ms": pms, "bound_ms": b, "bound_by": by, "share_of_bound": b / per_ms[1],
             "max_abs_err": err, "ptxas": K.ptxas("msm_weighted")}
    report["msm_weighted"]["detail"]["kzg_msm_table"] = whole
    emit({"phase": "kernels", "kernel": "msm_weighted", "kzg_msm_table": whole})
    del table, got, want
    torch.cuda.empty_cache()

    # the window sweep: the whole MSM at each c, in turns
    times = {str(w): [] for w in KZG_SWEEP_C}
    values = set()
    saved = config.DEFAULT.msm_window
    try:
        for _ in range(KZG_SWEEP_TURNS):
            for w in KZG_SWEEP_C:
                config.DEFAULT.msm_window = w
                out, ms = cuda_once(torch, lambda: M.msm(pts, sc))
                times[str(w)].append(ms)
                values.add(CU.decode_points(tuple(a.unsqueeze(0) for a in out))[0])
    finally:
        config.DEFAULT.msm_window = saved
    wins = {k: 0 for k in times}
    for t in range(KZG_SWEEP_TURNS):
        wins[min(times, key=lambda k: times[k][t])] += 1
    line = {"phase": "kzg_window_sweep", "points": N, "choose_window": c, "ms": times,
            "fastest_in_turns": wins, "same_point": len(values) == 1,
            "another_c_won_every_turn": any(v == KZG_SWEEP_TURNS for k, v in wins.items()
                                            if k != str(c))}
    report["msm_weighted"]["detail"]["kzg_window_sweep"] = line
    emit(line)
    if len(values) != 1:
        raise AssertionError("kzg_window_sweep: the MSM's value depends on its window")


def run_kzg_msm(torch, dev) -> None:
    """One single-row MSM of KZG_MSM_N points at c = 16 (W = 16 digit rows
    of 65,535 buckets: H4's 32-lane path) on points from the fixed-base
    table, against the host C MSM."""
    from spartan_tpu_torch.core import commitments as CM
    from spartan_tpu_torch.ops import curve as CU
    from spartan_tpu_torch.ops import curve_host as CH
    from spartan_tpu_torch.ops import field as F
    from spartan_tpu_torch.ops import msm as M
    from spartan_tpu_torch.ops.limbs import limbs_to_ints, to_numpy

    n, c = KZG_MSM_N, 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    pts = CM.points_from_scalars(rand_canon(torch, F.FR, n, gen)[3:], dev)
    sc = rand_canon(torch, F.FR, n - 3, gen)
    host_pts = CM._decode_affine(pts)
    got, ms = cuda_once(torch, lambda: M.msm(pts, sc, c=c))
    t = time.perf_counter()
    want = CH.msm(limbs_to_ints(to_numpy(sc)), host_pts)
    host_s = time.perf_counter() - t
    same = CU.decode_points(tuple(a.unsqueeze(0) for a in got))[0] == want
    emit({"phase": "kzg_msm", "points": n - 3, "c": c, "digit_rows": -(-254 // c),
          "buckets_per_row": (1 << c) - 1, "equal_to_host_c_msm": same, "msm_ms": ms,
          "host_c_msm_s": host_s})
    if not same:
        raise AssertionError("kzg_msm: the card's MSM disagrees with the host C MSM")


def run_ingest(torch, here: str) -> None:
    """tests/fixtures/multiplier2 through load_circom and keyless_bench.run
    on the card and on the CPU, both PCS modes: the proofs are equal, and
    the C parser's matrices equal the Python parser's."""
    from spartan_tpu_torch import native
    from spartan_tpu_torch.config import SpartanConfig
    from spartan_tpu_torch.io import keyless_bench as KB
    from spartan_tpu_torch.io import r1cs_reader as RR
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.utils.cachedir import subdir

    r1cs = os.path.join(here, "tests", "fixtures", "multiplier2.r1cs")
    wtns = os.path.join(here, "tests", "fixtures", "multiplier2.wtns")
    with open(r1cs, "rb") as f:
        data = f.read()
    r = RR.R1CSFile.from_bytes(data)
    off = 12 + 12 + int.from_bytes(data[16:24], "little") + 12   # the constraints section
    parsed = native.r1cs_parse_native(data, off, r.num_constraints, 32)
    if parsed is None:
        raise AssertionError("ingest: the C parser is not available or refused the file")
    c_mats = tuple([(int(a), int(b), int.from_bytes(raw[32 * i:32 * i + 32].tobytes(), "little"))
                    for i, (a, b) in enumerate(zip(rows, cols))]
                   for rows, cols, raw in parsed)
    if not c_mats == RR._parse_constraints_py(data, off, r.num_constraints, 32) == (r.a, r.b, r.c):
        raise AssertionError("ingest: the C parser's matrices differ from the Python parser's")
    for pcs in ("hyrax", "kzg"):
        config = SpartanConfig(pcs=pcs, srs_path=os.path.join(subdir("cache", "srs"),
                                                              "smoke_ingest.npz"))
        if os.path.exists(config.srs_path):
            os.remove(config.srs_path)
        out = {}
        for device in ("cuda", "cpu"):
            K.reset_counts()
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rep = KB.run(*KB.load_circom(r1cs, wtns), config=config, device=device,
                             tape_seed=bytes([3]) * 32)
            out[device] = (rep, time.perf_counter() - t, K.counts())
        same = out["cuda"][0]["proof_sha256"] == out["cpu"][0]["proof_sha256"]
        emit({"phase": "ingest", "pcs": pcs, "circuit": "tests/fixtures/multiplier2",
              "c_parser_equals_python": True, "identical": same,
              "proof_bytes": out["cuda"][0]["proof_bytes"],
              "sha256": out["cuda"][0]["proof_sha256"], "cuda_s": out["cuda"][1],
              "cpu_s": out["cpu"][1], "cuda_report": out["cuda"][0],
              "cuda_launches": out["cuda"][2], "cpu_launches": out["cpu"][2]})
        if not same:
            raise AssertionError(f"ingest ({pcs}): the card's proof differs from the CPU's")
        if max(out["cpu"][2].values()) > 0:
            raise AssertionError(f"ingest ({pcs}): the CPU run launched kernels")


def run_cross(torch, log2: int, snark_log2: int) -> None:
    """Device-path proofs on the card == the same proofs on the CPU: the
    NIZK, and the SNARK with either derefs commitment."""
    from spartan_tpu_torch.config import SpartanConfig
    from spartan_tpu_torch.core import hostpath as HP
    from spartan_tpu_torch.core import sumcheck_fused as SF
    from spartan_tpu_torch.io.keyless_bench import synthetic
    from spartan_tpu_torch.ops import field as F
    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.ops import msm as M
    from spartan_tpu_torch.snark import NIZK, SNARK, NIZKGens, SNARKGens
    from spartan_tpu_torch.utils.random_tape import RandomTape
    from spartan_tpu_torch.utils.serialization import serialize
    from spartan_tpu_torch.utils.cachedir import subdir
    from spartan_tpu_torch.utils.transcript import Transcript

    def nizk(device):
        inst, vars_, inputs, _ = synthetic(log2, seed=1)
        n = inst.inst.num_cons
        gens = NIZKGens(n, n, 1, device=device)
        proof = NIZK.prove(inst, vars_, inputs, gens, Transcript(b"cross"),
                           RandomTape(b"cross", seed=bytes([9]) * 32))
        proof.verify(inst, inputs, Transcript(b"cross"), gens)
        return proof

    def snark(device, pcs="hyrax"):
        inst, vars_, inputs, nnz = synthetic(snark_log2, seed=1)
        n = inst.inst.num_cons
        # KZG: the card's run generates the SRS there and saves it, the
        # CPU's run loads that file
        gens = SNARKGens(n, n, 1, nnz, device=device, config=SpartanConfig(
            pcs=pcs, srs_path=srs_path))
        comm, decomm = SNARK.encode(inst, gens)
        proof = SNARK.prove(inst, comm, decomm, vars_, inputs, gens, Transcript(b"cross"),
                            RandomTape(b"cross", seed=bytes([9]) * 32))
        proof.verify(comm, inputs, Transcript(b"cross"), gens)
        return comm, proof

    # every device path at these sizes; the SNARK keeps the small MSMs of
    # its bullet reductions on the host C backend (their plain versions
    # on the CPU would take minutes; the card's rounds above HOST_BULLET_N
    # run there), its row commits and KZG MSMs go to the device, and its
    # fused product sumchecks run rounds above the tail (T1, S1/S2) from
    # 2^6 entries down to T2's 2^5
    snark_lowered = (2, HP.HOST_MSM_N, 0, M.LADDER_N, 0, 1 << 5, HP.HOST_BULLET_N)
    lowered = {"nizk": (2, 4, 0, 4, 0, SF.SMALL_BUCKET_N, 4), "snark": snark_lowered,
               "snark_kzg": snark_lowered}
    srs_path = os.path.join(subdir("cache", "srs"), "smoke_cross.npz")
    if os.path.exists(srs_path):
        os.remove(srs_path)
    for what, fn in (("nizk", nizk), ("snark", snark),
                     ("snark_kzg", lambda device: snark(device, "kzg"))):
        saved = (HP.HOST_N, HP.HOST_MSM_N, HP.HOST_COMMIT_POINTS, M.LADDER_N,
                 F._HOST_CONVERT_N, SF.SMALL_BUCKET_N, HP.HOST_BULLET_N)
        (HP.HOST_N, HP.HOST_MSM_N, HP.HOST_COMMIT_POINTS, M.LADDER_N, F._HOST_CONVERT_N,
         SF.SMALL_BUCKET_N, HP.HOST_BULLET_N) = lowered[what]
        try:
            out = {}
            for device in ("cuda", "cpu"):
                K.reset_counts()
                t = time.perf_counter()
                res = fn(device)
                torch.cuda.synchronize()
                out[device] = (serialize(res), time.perf_counter() - t, K.counts())
        finally:
            (HP.HOST_N, HP.HOST_MSM_N, HP.HOST_COMMIT_POINTS, M.LADDER_N, F._HOST_CONVERT_N,
             SF.SMALL_BUCKET_N, HP.HOST_BULLET_N) = saved
        same = all(v[0] == out["cpu"][0] for v in out.values())
        emit({"phase": "cross", "what": what, "log2": log2 if what == "nizk" else snark_log2,
              "identical": same, "sha256": hashlib.sha256(out["cuda"][0]).hexdigest(),
              **{f"{k}_s": v[1] for k, v in out.items()},
              **{f"{k}_launches": v[2] for k, v in out.items()}})
        if not same:
            raise AssertionError(f"{what}: the card's proofs differ from the CPU proof")
        # the card's run went through every kernel, the CPU run through none
        need = NIZK_KERNELS if what == "nizk" else tuple(SOURCES)
        if min(out["cuda"][2][k] for k in need) <= 0 or max(out["cpu"][2].values()) > 0:
            raise AssertionError(f"{what} cross check launches: {out['cuda'][2]}, "
                                 f"{out['cpu'][2]}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
