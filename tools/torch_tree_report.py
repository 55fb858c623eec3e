#!/usr/bin/env python3
"""Kernel readings of another checkout of spartan_tpu_torch, for comparing it
with this one on the same card in the same chip call.

    git archive <commit> | tar -x -C build/parent     # build/ is gitignored
    python3 tools/torch_tree_report.py build/parent

In a subprocess whose imports resolve to the other tree, it runs that
tree's own ``chip_smoke.py`` kernel checks (``check_kernels``,
``check_sumcheck_kernels``: every kernel against its plain version, times
and bounds), then with this tree's smoke helpers S2's step at the
mid-size round and the MSM's Horner stage as that tree runs it
(``msm._horner_windows``) at the prove's two MSM shapes, and one 2^20
SNARK encode + prove in which every kernel wrapper call is timed (the
host clock around the wrapper, CUDA events around each C launch inside it,
keyed by kernel, entry, call site and size), as this tree's
``kernels.timed`` records them. Then it reads the
other tree's build: each library's ptxas report and the SASS of H1's mul
kernels, with this tree's ``kernels.parse_ptxas`` and ``kernels.sass``.
Prints one JSON line per reading. Needs one CUDA card.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import importlib.util, json, os, sys, time
tree, smoke_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
import torch
import chip_smoke as S
spec = importlib.util.spec_from_file_location("this_smoke", smoke_path)
T = importlib.util.module_from_spec(spec)
spec.loader.exec_module(T)
from spartan_tpu_torch.ops import curve as CU
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import kernels as K
from spartan_tpu_torch.ops import msm as M
from spartan_tpu_torch.ops import sumcheck_kernels as SK

def emit(o):
    print(json.dumps(o), flush=True)

dev = torch.device("cuda")
emit({"phase": "build", "per_source_s": K.build_all()})
report = {name: {"name": name} for name in S.SOURCES}
S.check_kernels(torch, dev, report)
S.check_sumcheck_kernels(torch, dev, report)
emit({"phase": "kernels", "report": report})
gen = torch.Generator(device=dev)
gen.manual_seed(22)
emit({"phase": "sc_round_prod mid round", **T.prod_round_ms(torch, dev, gen, T.SC_PROD_MID_N)})
for label, rows, c in T.HORNER_SHAPES:
    W = -(-254 // c)
    win = tuple(T.rand_canon(torch, F.FQ, W * rows, gen).reshape(W, rows, 8) for _ in range(3))
    emit({"phase": "horner stage", "shape": label, "rows": rows, "c": c, "windows": W,
          "ms": T.cuda_ms(torch, lambda: M._horner_windows(win, c), 3)})
    del win

# one 2^20 encode + prove with every wrapper call timed: the host clock
# around the Python wrapper, CUDA events around each C launch inside it
records = []       # [kernel, entry, site, size, host s, [(start, end event)]]
current = [None]   # the wrapper call running now

def site(skip):
    f = sys._getframe(2)
    while f is not None and os.path.abspath(f.f_code.co_filename) == skip:
        f = f.f_back
    return f"{os.path.splitext(os.path.basename(f.f_code.co_filename))[0]}.{f.f_code.co_name}"

def wrap(mod, fn, kernel, entry, size):
    """Time every call of the wrapper mod.fn; kernel, entry, size: of its
    arguments."""
    inner = getattr(mod, fn)
    path = os.path.abspath(mod.__file__)
    def timed(*a, **k):
        if not collecting[0]:
            return inner(*a, **k)
        rec = [kernel(a), entry(a), site(path), size(a), 0.0, []]
        prev, current[0] = current[0], rec
        t = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            rec[4] = time.perf_counter() - t
            current[0] = prev
            records.append(rec)
    setattr(mod, fn, timed)

def wrap_c(name):
    """CUDA events around every C launch function of a kernel's library."""
    h = K.lib(name)
    for fn in K._SIGNATURES[name]:
        def timed(*a, inner=getattr(h, fn)):
            if not collecting[0] or current[0] is None:
                return inner(*a)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            rc = inner(*a)
            e.record()
            current[0][5].append((s, e))
            return rc
        setattr(h, fn, timed)

for name in S.SOURCES:
    wrap_c(name)
collecting = [False]
pts = lambda a: a[0][0].numel() // 8
named = lambda name: (lambda a: name)
wrap(F, "launch_field_ew", named("field_ew"), lambda a: f"{a[1].name}.{a[0]}", lambda a: a[6])
wrap(CU, "launch_padd", named("curve_ew"), named("padd"), pts)
wrap(CU, "launch_pdbl", named("curve_ew"), named("pdbl"), pts)
wrap(M, "launch_msm_bucket", named("msm_bucket"), named("bucket_sums"),
     lambda a: a[3].shape[0])
wrap(M, "launch_msm_weighted", named("msm_weighted"), named("weighted_sums"),
     lambda a: a[0][0].shape[0])
wrap(SK, "fold", named("sc_fold"), named("fold"), lambda a: sum(t.shape[0] for t in a[0]))
wrap(SK, "_launch_prod", named("sc_round_prod"), lambda a: "step" if a[0] else "evals",
     lambda a: len(a[1]) * a[1][0].shape[0])
wrap(SK, "_launch_single", lambda a: a[0], lambda a: "step" if a[2] else "evals",
     lambda a: a[3][0].shape[0])

from spartan_tpu_torch.io.keyless_bench import synthetic
from spartan_tpu_torch.snark import SNARK, SNARKGens
from spartan_tpu_torch.utils.random_tape import RandomTape
from spartan_tpu_torch.utils.timer import Timer
from spartan_tpu_torch.utils.transcript import Transcript
inst, vars_, inputs, nnz = synthetic(T.SNARK_LOG2)
n = inst.inst.num_cons
gens = SNARKGens(n, n, 1, nnz)
Timer.collect()
t = time.perf_counter()
comm, decomm = SNARK.encode(inst, gens)
torch.cuda.synchronize()
encode_s = time.perf_counter() - t
K.reset_counts()
Timer.collect()
Timer.acc_reset()
collecting[0] = True
torch.cuda.reset_peak_memory_stats()
t = time.perf_counter()
SNARK.prove(inst, comm, decomm, vars_, inputs, gens, Transcript(b"chip_smoke"),
            RandomTape(b"chip_smoke", seed=bytes([5]) * 32))
torch.cuda.synchronize()
prove_s = time.perf_counter() - t
collecting[0] = False
counts = K.counts()
agg = {}
for kernel, entry, where, size, host, events in records:
    if not events:
        continue
    r = agg.setdefault((kernel, entry, where, size), [0, 0.0, 0.0])
    for s, e in events:
        e.synchronize()
        r[0] += 1
        r[1] += s.elapsed_time(e)
    r[2] += host * 1e3
rows = [{"kernel": k[0], "entry": k[1], "site": k[2], "n": k[3], "launches": v[0],
         "device_ms": v[1], "host_ms": v[2]} for k, v in agg.items()]
totals = {}
for r in rows:
    t = totals.setdefault(r["kernel"], {"launches": 0, "device_ms": 0.0, "host_ms": 0.0})
    for k in ("launches", "device_ms", "host_ms"):
        t[k] += r[k]
emit({"phase": "snark", "encode_s": encode_s, "prove_s": prove_s, "launches": counts,
      "prove_peak_device_bytes": torch.cuda.max_memory_allocated(), "kernel_totals": totals,
      "h2_launches": [r for r in rows if r["kernel"] == "curve_ew"]})
'''


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    tree = os.path.abspath(sys.argv[1])
    rc = subprocess.run([sys.executable, "-c", CHILD, tree, os.path.join(HERE, "chip_smoke.py")],
                        cwd=tree).returncode
    if rc:
        return rc
    sys.path.insert(0, HERE)
    from spartan_tpu_torch.ops import kernels as K

    for txt in sorted(glob.glob(os.path.join(tree, "build", "kernels", "*.ptxas.txt"))):
        with open(txt, encoding="utf-8", errors="replace") as f:
            print(json.dumps({"phase": "ptxas", "library": os.path.basename(txt),
                              "functions": K.parse_ptxas(f.read())}), flush=True)
    for so in glob.glob(os.path.join(tree, "build", "kernels", "field_ew_*.so")):
        print(json.dumps({"phase": "sass", "library": os.path.basename(so),
                          "functions": {fn: v for fn, v in K.sass(so).items()
                                        if "field_ew_kernelILi0E" in fn}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
