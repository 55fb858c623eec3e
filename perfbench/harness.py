"""One run of one cell: set-up, the measured window, the check, the result.

Set-up makes the cell's inputs from the seed (``perfbench/gen``): the
instance and a pool of witnesses, as many as the traffic mix's
``witnesses``. It builds the prover (kernels, instance, generators, under
KZG the SRS, for a SNARK the encode) and proves and verifies witness 0 to
warm up. The window is a closed loop of one prover: iteration ``i`` proves
witness ``i + 1`` (modulo the pool) in assignment objects of its own, with
its own random tape, and verifies the proof with the port's verifier
against that witness's public inputs; an iteration that starts inside the
window runs to its end and counts. Then the plain verifier judges the
proofs (``check``) and the result is printed.

Each prove's host side is recorded beside it (``host_each``: the
process's CPU time and the garbage collector's seconds and full
collections), and the seconds of each verify (``verify_each_s``).

With ``trace`` the window runs under ``torch.profiler`` with the program's
spans and kernel events on, and the result carries the per-layer metrics
instead of the end-to-end ones.

A cell on more than one chip is one sharded prover: ``perfbench/ranks.py``
starts a rank per card, and each runs this same loop with a ``Group``.
Rank 0 alone writes the circuit cache and builds the kernels before the
others build their inputs; every rank encodes and proves with ``mesh=``.
Rank 0 owns the window's clock and tells every rank before each iteration
whether to go on, so all prove the same witnesses with the same tapes the
same number of times; a prove's time runs from a barrier to a barrier after
every rank's synchronise (the slowest rank's latency); rank 0 alone
verifies. After the window the ranks' peaks, proof digests and, traced,
device busy seconds are gathered to rank 0, which reports the fullest
card's peak and the mean busy seconds, is judged by the plain verifier, and
adds one check: ``rank_proofs_differ``, the proofs whose bytes on some rank
differ from rank 0's. The per-layer metrics read rank 0's spans and trace.
A rank that fails mid-prove would leave the others in a collective, so
there a failed prove ends the run instead of being counted.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import resource
import sys
import time
import traceback

BANNED = ("jax", "jaxlib", "flax", "spartan_tpu")


def process_start() -> float:
    """The time.time() at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def tape_seed(seed: int, iteration: int | str) -> bytes:
    return hashlib.sha256(f"perfbench-tape/{seed}/{iteration}".encode()).digest()


class Failure(Exception):
    """A run that must print no result."""


class GcClock:
    """Seconds and full collections of the garbage collector while on."""

    def __init__(self):
        self.seconds, self.full, self._t = 0.0, 0, None
        gc.callbacks.append(self._cb)

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.full += info.get("generation") == 2
            self._t = None

    def close(self) -> None:
        gc.callbacks.remove(self._cb)


def host_sample(clock: GcClock) -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "gc_s": clock.seconds, "gc_full": clock.full}


def run(root: str, workload: str, seed: int, seconds: float, trace: bool, *,
        device=None, started: float | None = None, control=None, group=None) -> dict | None:
    """The result's dict. ``device`` None means the CUDA card (required).
    ``control`` (the control script and the tests) is applied to the
    prover after set-up, to break what it proves; the port's own verifier
    is then not run on the warm-up proof. A cell on more than one chip is
    run by ``ranks.launch``, which calls this in each rank with its
    ``group``; there ranks other than 0 return None."""
    import torch

    from perfbench import check, tracing
    from perfbench.registry import Bench

    started = process_start() if started is None else started
    bench = Bench(root)
    cell = bench.cell(workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Failure(f"{workload} needs {cell['chips']} CUDA device(s)")
    traffic = bench.traffic(cell)
    if traffic.get("sharded", False) != (cell["chips"] > 1):
        raise Failure("a sharded traffic mix runs on more than one chip, any other on one")
    if cell["chips"] > 1 and group is None:
        from perfbench import ranks

        return ranks.launch(root, workload, seed, seconds, trace, cell["chips"], device=device,
                            started=started, control=control)
    device = torch.device("cuda" if device is None else device)
    lead = group is None or group.rank == 0   # owns the window's clock, verifies, reports
    config = bench.config(cell)
    if traffic.get("loop", "closed") != "closed" or traffic.get("provers", 1) != 1:
        raise Failure("the harness runs a closed loop of one prover only")

    from perfbench import sut

    phases = {"start_s": time.time() - started}
    t = time.perf_counter()
    if not lead:
        group.barrier()   # rank 0 writes the circuit cache and builds the kernels first
    inputs = bench.generator(config).build(config, seed, os.path.join(bench.dir, ".cache"),
                                           traffic.get("witnesses", 1), device)
    pool = inputs["witnesses"] if control is None else control(inputs["witnesses"])
    if device.type == "cuda":
        torch.cuda.empty_cache()   # the prover starts on an empty cache, as without a pool
    if group is not None:
        if lead:
            sut.build_kernels(device)
            group.barrier()
        group.beat("inputs")
    phases["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    prover = sut.Prover(inputs, traffic, device, mesh=None if group is None else group.mesh)
    phases["prover_s"] = time.perf_counter() - t
    if group is not None:
        group.beat("prover")
    t = time.perf_counter()
    vars_, public = prover.assign(pool[0])
    warm = prover.prove(tape_seed(seed, "warm-up"), vars_, public)
    sut.sync(device)
    if control is None and lead:
        prover.verify(warm, public)
    del warm, vars_, public
    sut.sync(device)
    phases["warm_up_s"] = time.perf_counter() - t
    # every run enters the window with the set-up's garbage collected
    t = time.perf_counter()
    gc.collect()
    phases["gc_full_s"] = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        prof = profile(activities=acts)
    per_proof, proofs, publics, prove_s, verify_s, host_each = [], [], [], [], [], []
    failed = attempted = 0
    clock = GcClock()
    if group is not None:
        group.beat("window")
        group.barrier()
    setup_s = time.time() - started
    with prof if prof is not None else contextlib.nullcontext():
        w0 = time.perf_counter()

        def more() -> bool:
            inside = time.perf_counter() - w0 < seconds
            return inside if group is None else group.go(inside)

        while more():
            attempted += 1
            witness = pool[attempted % len(pool)]
            if trace:
                sut.collect(True)
            try:
                vars_, public = prover.assign(witness)
                if group is not None:
                    group.barrier()
                h0 = host_sample(clock)
                t0 = time.perf_counter()
                with tracing_range(trace, tracing.PROVE):
                    proof = prover.prove(tape_seed(seed, attempted - 1), vars_, public)
                    sut.sync(device)
                if group is not None:
                    group.barrier()
                    group.beat(f"window, iteration {attempted}")
                t1 = time.perf_counter()
                h1 = host_sample(clock)
                host_each.append({k: h1[k] - h0[k] for k in h0})
                del vars_
                if trace:
                    per_proof.append({"spans": sut.spans(), "kernels": sut.kernel_timings()})
                    sut.collect(False)
                proofs.append(proof)
                publics.append(witness[0])
                t2 = time.perf_counter()
                if lead:
                    with tracing_range(trace, tracing.VERIFY):
                        prover.verify(proof, public)
                        sut.sync(device)
                t3 = time.perf_counter()
            except Exception:  # noqa: BLE001 - a failed iteration is counted, not fatal
                if group is not None and len(proofs) < attempted:
                    raise   # the other ranks would wait for this one inside the prove
                failed += 1
                traceback.print_exc(file=sys.stderr)
                continue
            prove_s.append(t1 - t0)
            verify_s.append(t3 - t2)
        window_s = time.perf_counter() - w0
    clock.close()
    if trace:
        sut.collect(False)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = banned_modules()
    if found:
        raise Failure(f"modules loaded in this process: {', '.join(found)}")

    raw = [prover.proof_bytes(p) for p in proofs]
    commitment = prover.commitment_bytes()
    setup_spans = dict(prover.setup_spans)
    del prover, proofs, pool
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    traced = tracing.read(prof) if prof is not None else {}
    del prof
    phases["trace_read_s"] = time.perf_counter() - t
    busy_s = traced.get("busy_s", 0.0)
    if group is not None:
        every = group.gather({"peak": peak, "setup_peak": setup_peak, "busy_s": busy_s,
                              "digests": [hashlib.sha256(r).digest() for r in raw],
                              "device": str(device), "backend": group.mesh.backend})
        group.beat("gathered")
        group.close()
        if not lead:
            return None
        peak = max(r["peak"] for r in every)
        setup_peak = max(r["setup_peak"] for r in every)
        busy_s = sum(r["busy_s"] for r in every) / len(every)
        differ = sum(any(r["digests"][i:i + 1] != [d] for r in every)
                     for i, d in enumerate(every[0]["digests"]))
    t = time.perf_counter()
    checks = check.Reference(inputs, traffic).judge(publics, raw, commitment, seed, failed)
    if group is not None:
        checks["rank_proofs_differ"] = {"value": differ, "limit": 0}
    phases["reference_s"] = time.perf_counter() - t
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    if trace:
        bundle = {"setup": setup_spans, "proofs": per_proof, "verifies": verify_s,
                  "trace": traced}
        metrics = {}
        for m in bench.metrics(cell, "per_layer"):
            v = bench.metric_reader(m["name"]).read(bundle)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s,
                  "prove_s": sum(prove_s) / len(prove_s) if prove_s else None,
                  "verify_s": sum(verify_s) / len(verify_s) if verify_s else None,
                  "prove_peak_gb": peak / 1e9 if device.type == "cuda" else None}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench.metrics(cell, "end_to_end")
                   if values.get(m["name"]) is not None}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": max(peak, setup_peak)}
    if trace:
        dev["busy_s"] = busy_s
        dev["window_s"] = traced.get("window_s", window_s)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and "device_ops" in traced:
        out["breakdown"] = {"device_ops": traced["device_ops"],
                            "idle_gaps": traced["idle_gaps"]}
    out["proofs"] = len(prove_s)
    out["window_s"] = window_s
    out["prove_each_s"] = prove_s
    out["verify_each_s"] = verify_s
    if trace:   # each proof's outermost spans, to see where one proof differs from another
        out["spans_each_s"] = [{lbl: dt for d, lbl, dt in p["spans"] if d <= 1}
                               for p in per_proof]
    out["phases"] = phases
    out["host_each"] = host_each
    if group is not None:
        out["ranks"] = [{"device": r["device"], "backend": r["backend"], "peak": r["peak"]}
                        for r in every]
    out["checks"] = checks
    return out


@contextlib.contextmanager
def tracing_range(on: bool, name: str):
    if not on:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield


def main(argv=None) -> int:
    import argparse

    started = process_start()
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    try:
        out = run(root, args.workload, args.seed, args.seconds, bool(args.trace),
                  started=started)
    except Failure as e:
        print(f"perfbench: {e}", file=sys.stderr, flush=True)
        return 2
    found = banned_modules()
    if found:
        print(f"perfbench: modules loaded in this process: {', '.join(found)}",
              file=sys.stderr, flush=True)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
