"""Keyless-circuit benchmark driver with phase-by-phase timing.

Counterpart of ``spartan_tpu/io/keyless_bench.py`` (the reference's
examples/keyless_benchmark.rs): load .r1cs/.wtns -> convert (circom column
remap) -> gens -> encode -> instrumented SNARK prove -> verify -> report.
The keyless circuit's files are not in the repository, so
``--synthetic LOG2`` generates a random satisfiable R1CS of that size
instead (the same seeded generator as the JAX package's).

Runs on the CUDA card unless ``--device cpu``; every timed phase ends in
``torch.cuda.synchronize()`` on the card. ``--mesh N`` shards encode and
prove over N ranks (``parallel/``): under ``torchrun`` the process joins the
world torchrun started, otherwise it starts a world of N processes on this
host; the ranks share one transcript and tape seed, and only rank 0 prints
the report, with every rank's device and peak memory.

Usage:
    python -m spartan_tpu_torch.io.keyless_bench --r1cs main.r1cs --wtns w.wtns
    python -m spartan_tpu_torch.io.keyless_bench --synthetic 20 [--pcs kzg] [--json]
    python -m spartan_tpu_torch.io.keyless_bench --synthetic 10 --device cpu \\
        --save DIR                      # then --verify-only DIR
    python -m spartan_tpu_torch.io.keyless_bench --synthetic 20 --profile DIR
    python -m spartan_tpu_torch.io.keyless_bench --synthetic 20 --mesh 2
    torchrun --standalone --nproc-per-node 2 -m spartan_tpu_torch.io.keyless_bench \
        --synthetic 20 --mesh 2
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import subprocess
import time

import torch
import torch.distributed as dist

from spartan_tpu_torch import device as DEV
from spartan_tpu_torch.io.r1cs_reader import R1CSFile, parse_wtns
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.snark import SNARK, Assignment, Instance, SNARKGens
from spartan_tpu_torch.utils.math import log_2, next_power_of_two
from spartan_tpu_torch.utils.random_tape import RandomTape
from spartan_tpu_torch.utils.timer import Timer
from spartan_tpu_torch.utils.transcript import Transcript


def load_circom(r1cs_path: str, wtns_path: str):
    """(instance, vars, inputs, max nnz) of a circom circuit and witness."""
    from spartan_tpu_torch.core.r1cs import R1CSShape

    r = R1CSFile.from_file(r1cs_path)
    num_vars_padded = next_power_of_two(max(r.num_private_vars(), r.num_pub_inputs + 1))
    num_cons_padded = next_power_of_two(max(r.num_constraints, 2))
    A, B, C = r.to_sparse_matrices_padded(num_vars_padded)
    shape = R1CSShape(num_cons_padded, num_vars_padded, r.num_pub_inputs, A, B, C)
    inst = Instance.from_shape(shape)

    wit = parse_wtns(wtns_path)
    pubs = wit[1:1 + r.num_pub_inputs]
    privs = wit[1 + r.num_pub_inputs:]
    vars_ = Assignment(privs + [0] * (num_vars_padded - len(privs)))
    inputs = Assignment(pubs)
    max_nnz = max(len(shape.A.vals), len(shape.B.vals), len(shape.C.vals))
    return inst, vars_, inputs, max_nnz


def synthetic(log2_cons: int, num_inputs: int = 1, nnz_per_row: int = 3, seed: int = 0):
    """Random satisfiable R1CS at 2^log2_cons constraints/variables."""
    from spartan_tpu_torch.core.r1cs import R1CSShape

    rng = random.Random(seed)
    n = 1 << log2_cons
    vars_ = [rng.randrange(FR_MOD) for _ in range(n)]
    inputs = [rng.randrange(FR_MOD) for _ in range(num_inputs)]
    z = vars_ + [1] + inputs
    A, B, C = [], [], []
    for i in range(n):
        az = bz = 0
        for _ in range(nnz_per_row):
            ca, cb = rng.randrange(len(z)), rng.randrange(len(z))
            va, vb = rng.randrange(1, FR_MOD), rng.randrange(1, FR_MOD)
            A.append((i, ca, va))
            B.append((i, cb, vb))
            az = (az + va * z[ca]) % FR_MOD
            bz = (bz + vb * z[cb]) % FR_MOD
        C.append((i, n, az * bz % FR_MOD))
    shape = R1CSShape(n, n, num_inputs, A, B, C)
    max_nnz = max(len(A), len(B), len(C))
    return Instance.from_shape(shape), Assignment(vars_), Assignment(inputs), max_nnz


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or 'cpu'."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()
        return out[dev.index or 0] if out else torch.cuda.get_device_name(dev)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def _build_kernels(dev: torch.device) -> float:
    """Build the CUDA kernels before anything is timed (on a card): seconds."""
    if dev.type != "cuda":
        return 0.0
    from spartan_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    K.build_all()
    return time.perf_counter() - t0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _phases() -> list:
    return [{"depth": d, "label": lbl, "s": round(dt, 4)} for d, lbl, dt in Timer.records()]


def verify_only(inst, vars_, inputs, max_nnz, load_dir: str, pcs: str = "hyrax",
                json_out: bool = False, reps: int = 3, device=None):
    """Time SNARK.verify of a proof and commitment saved by an earlier
    ``run(..., save_dir=...)`` (of either package): the instance and gens
    are made anew (deterministic), the proof and commitment are read from
    their canonical bytes, so the full adversarial deserialization runs
    every time."""
    from spartan_tpu_torch.config import SpartanConfig
    from spartan_tpu_torch.core.r1cs import R1CSCommitment
    from spartan_tpu_torch.utils.serialization import deserialize

    dev = DEV.resolve(device)
    shape = inst.inst
    gens = SNARKGens(shape.num_cons, shape.num_vars, shape.num_inputs, max_nnz,
                     config=SpartanConfig(pcs=pcs), device=dev)
    with open(os.path.join(load_dir, "proof.bin"), "rb") as f:
        proof = deserialize(SNARK, f.read(), pcs=pcs)
    with open(os.path.join(load_dir, "comm.bin"), "rb") as f:
        comm = deserialize(R1CSCommitment, f.read(), pcs=pcs)

    report: dict = {"num_cons": shape.num_cons, "pcs": pcs, "mode": "verify_only",
                    "reps": reps, "backend": dev.type, "device": device_name(dev),
                    "build_s": _build_kernels(dev)}
    times = []
    for i in range(reps):
        Timer.collect()
        t0 = time.perf_counter()
        proof.verify(comm, inputs, Transcript(b"keyless_bench"), gens)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        if i == reps - 1:
            report["verify_phases"] = _phases()
        Timer.collect(False)
    report["verify_s"] = min(times)
    report["verify_s_all"] = [round(t, 4) for t in times]
    report["verified"] = True
    if json_out:
        print(json.dumps(report))
    else:
        print(f"  verify (best of {reps}): {min(times):.3f} s  all={times}")
    return report


def run(inst, vars_, inputs, max_nnz, pcs: str = "hyrax", json_out: bool = False,
        config=None, save_dir: str | None = None, device=None,
        profile_dir: str | None = None, tape_seed: bytes | None = None, mesh=None):
    """Gens, encode, prove, verify with each phase timed; ``profile_dir``
    traces the prove with torch.profiler (CPU and CUDA activities) into
    ``profile_dir/prove_trace.json``, the program's spans a track of
    ranges on its host timeline.
    The prover's random tape is seeded from ``tape_seed`` (OS randomness
    if None, rank 0's under a mesh), so two runs of one seed make the same
    proof. With ``mesh`` every rank calls this; encode and prove are
    sharded over the mesh (on its device) and only rank 0 prints."""
    from spartan_tpu_torch.config import SpartanConfig
    from spartan_tpu_torch.utils.serialization import serialize

    if config is None:
        config = SpartanConfig(pcs=pcs)
    pcs = config.pcs
    if config.profile:
        Timer.enable()
    dev = mesh.device if mesh is not None else DEV.resolve(device)
    shape = inst.inst
    report: dict = {
        "num_cons": shape.num_cons, "num_vars": shape.num_vars,
        "num_inputs": shape.num_inputs,
        "nnz": [len(shape.A.vals), len(shape.B.vals), len(shape.C.vals)],
        "pcs": pcs, "backend": dev.type, "device": device_name(dev),
        "mesh_devices": mesh.size if mesh is not None else 0,
        "build_s": _build_kernels(dev),
    }
    if mesh is not None:
        report["mesh_backend"] = mesh.backend
        if tape_seed is None:
            box = [os.urandom(32)]
            dist.broadcast_object_list(box, src=0)
            tape_seed = box[0]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    Timer.collect()
    t0 = time.perf_counter()
    gens = SNARKGens(shape.num_cons, shape.num_vars, shape.num_inputs, max_nnz,
                     config=config, device=dev)
    _sync(dev)
    report["gens_s"] = time.perf_counter() - t0
    report["gens_phases"] = _phases()

    Timer.collect()
    t0 = time.perf_counter()
    comm, decomm = SNARK.encode(inst, gens, mesh=mesh)
    _sync(dev)
    report["encode_s"] = time.perf_counter() - t0
    report["encode_phases"] = _phases()

    prof = None
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    Timer.collect()
    Timer.acc_reset()
    t0 = time.perf_counter()
    try:
        proof = SNARK.prove(inst, comm, decomm, vars_, inputs, gens,
                            Transcript(b"keyless_bench"),
                            RandomTape(b"snark_proof", seed=tape_seed), mesh=mesh)
        _sync(dev)
        report["prove_s"] = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    report["prove_phases"] = _phases()
    report["prove_acc"] = [{"label": lbl, "s": round(v, 4)} for lbl, v in Timer.acc_records()]
    if prof is not None:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "prove_trace.json"))
        report["profile"] = {"trace": os.path.join(profile_dir, "prove_trace.json")}

    Timer.collect()
    t0 = time.perf_counter()
    proof.verify(comm, inputs, Transcript(b"keyless_bench"), gens)
    _sync(dev)
    report["verify_s"] = time.perf_counter() - t0
    report["verify_phases"] = _phases()
    Timer.collect(False)
    report["verified"] = True

    raw = serialize(proof)
    report["proof_bytes"] = len(raw)
    report["proof_sha256"] = hashlib.sha256(raw).hexdigest()
    if save_dir is not None and (mesh is None or mesh.rank == 0):
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "proof.bin"), "wb") as f:
            f.write(raw)
        with open(os.path.join(save_dir, "comm.bin"), "wb") as f:
            f.write(serialize(comm))

    # published reference sizes at keyless scale (BENCHMARK_RESULTS.md:86-92)
    report["ref_proof_bytes_keyless"] = 252_314 if pcs == "hyrax" else 120_422
    if dev.type == "cuda":
        report["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    if mesh is not None:
        ranks = [None] * mesh.size
        dist.all_gather_object(ranks, {"rank": mesh.rank, "device": str(dev),
                                       "peak_device_bytes": report.get("peak_device_bytes"),
                                       "proof_sha256": report["proof_sha256"]})
        report["mesh_ranks"] = ranks
        if len({r["proof_sha256"] for r in ranks}) != 1:
            raise RuntimeError(f"the ranks' proofs differ: {ranks}")
        if mesh.rank != 0:
            return report

    if json_out:
        print(json.dumps(report))
    else:
        print(f"  constraints 2^{log_2(shape.num_cons)}  vars 2^{log_2(shape.num_vars)}"
              f"  nnz {report['nnz']}  pcs={pcs}  device={report['device']}")
        for k in ("gens_s", "encode_s", "prove_s", "verify_s"):
            print(f"  {k:10s} {report[k]:9.2f}")
        print(f"  proof size {report['proof_bytes'] / 1024:.1f} KB "
              f"(reference at keyless 2^20 scale: "
              f"{report['ref_proof_bytes_keyless'] / 1024:.1f} KB)")
        print("  prove phase breakdown:")
        for ph in report["prove_phases"]:
            print(f"    {'  ' * ph['depth']}{ph['label']:40s} {ph['s']:9.2f} s")
        print("  verification: OK")
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--r1cs")
    ap.add_argument("--wtns")
    ap.add_argument("--synthetic", type=int, metavar="LOG2",
                    help="use a random satisfiable R1CS of 2^LOG2 constraints")
    ap.add_argument("--pcs", choices=("hyrax", "kzg"), default="hyrax")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard encode and prove over N ranks (joins torchrun's world, "
                         "else starts N processes on this host)")
    ap.add_argument("--profile", metavar="DIR",
                    help="trace the prove with torch.profiler into DIR/prove_trace.json")
    ap.add_argument("--save", metavar="DIR",
                    help="save proof.bin/comm.bin (canonical bytes) after prove")
    ap.add_argument("--verify-only", metavar="DIR",
                    help="skip encode/prove; load proof.bin/comm.bin from DIR "
                         "and time verification alone (requires the same "
                         "--synthetic/--r1cs instance arguments)")
    args = ap.parse_args(argv)

    if not (args.synthetic is not None or (args.r1cs and args.wtns)):
        ap.error("provide --r1cs/--wtns or --synthetic LOG2")
    if args.mesh > 1:
        if args.verify_only or args.profile:
            ap.error("--mesh shards encode and prove: not with --verify-only or --profile")
        if "WORLD_SIZE" in os.environ:
            from spartan_tpu_torch.parallel import init_distributed, make_mesh

            init_distributed(device=args.device)
            try:
                _mesh_rank(make_mesh(args.mesh, device=args.device), args)
            finally:
                dist.destroy_process_group()
        else:
            from spartan_tpu_torch.parallel.launch import spawn

            _build_kernels(torch.device("cpu" if args.device == "cpu" else "cuda"))
            spawn(_mesh_rank, args.mesh, args, device=args.device)
        return

    data = _data(args)
    if args.verify_only:
        verify_only(*data, load_dir=args.verify_only, pcs=args.pcs, json_out=args.json,
                    device=args.device)
    else:
        run(*data, pcs=args.pcs, json_out=args.json, save_dir=args.save,
            device=args.device, profile_dir=args.profile)


def _data(args):
    if args.synthetic is not None:
        return synthetic(args.synthetic)
    return load_circom(args.r1cs, args.wtns)


def _mesh_rank(mesh, args) -> None:
    """One rank of ``--mesh``: the same instance, a sharded run."""
    run(*_data(args), pcs=args.pcs, json_out=args.json, save_dir=args.save, mesh=mesh)


if __name__ == "__main__":
    main()
