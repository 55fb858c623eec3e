"""One cell across several cards: a process per rank, one rank per card.

``launch`` starts the cell's ``chips`` ranks with the ``spawn`` start
method and a ``file://`` rendezvous in a temporary directory, as
``spartan_tpu_torch/parallel/launch.py`` does. Each rank binds its own
device (``cuda:<rank>``, or the CPU in the tests), joins the port's
process group (NCCL on cards, gloo on the CPU: never a fallback from one to
the other) and runs ``harness.run`` with a ``Group``. Rank 0's result comes
back through the directory, and the launcher hands it on only once every
rank has ended with 0: it is the one process that prints.

The port's collectives wait 1,800 s for a missing rank, so the launcher
watches the ranks itself. A rank that raises or dies ends the run at once;
so does a stall, ``STALL_S`` seconds in which no rank has reached a new
phase (each rank writes the phase it reached to a file of its own). Either
way every rank is killed and ``harness.Failure`` raised: no result.
"""

from __future__ import annotations

import ctypes
import multiprocessing as mp
import multiprocessing.connection
import os
import pickle
import signal
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

# seconds without a new phase on any rank before the run is ended as hung;
# the longest healthy phase is a first run's kernel build (PERF.md)
STALL_S = 240.0


class Group:
    """A rank's view of the run's world: the port's ``mesh``, and a gloo
    group of the harness's own for its barriers, broadcasts and gathers, so
    that a rank waiting for another waits on the host and never in an NCCL
    kernel that the device trace would count as work."""

    def __init__(self, rank: int, size: int, tmp: str, mesh):
        self.rank, self.size, self.tmp, self.mesh = rank, size, tmp, mesh
        self._ctl = dist.new_group(backend="gloo")

    def beat(self, phase: str) -> None:
        """Tell the launcher this rank has reached ``phase``."""
        path = os.path.join(self.tmp, f"beat{self.rank}")
        with open(path + ".part", "w", encoding="utf-8") as f:
            f.write(phase)
        os.replace(path + ".part", path)

    def barrier(self) -> None:
        dist.barrier(group=self._ctl)

    def go(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        t = torch.tensor([int(flag)])
        dist.broadcast(t, 0, group=self._ctl)
        return bool(t.item())

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self._ctl)
        return out

    def close(self) -> None:
        dist.destroy_process_group()


def launch(root: str, workload: str, seed: int, seconds: float, trace: bool, chips: int, *,
           device=None, started: float, control=None) -> dict:
    """Rank 0's result of the cell's run on ``chips`` ranks. ``device``
    None means a card per rank, "cpu" CPU ranks; ``control`` as in
    ``harness.run`` (it must pickle)."""
    job = {"root": root, "workload": workload, "seed": seed, "seconds": seconds,
           "trace": trace, "device": device, "started": started, "control": control,
           "threads": max(1, torch.get_num_threads() // chips), "parent": os.getpid()}
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="perfbench-ranks-") as tmp:
        procs = [ctx.Process(target=_rank, args=(r, chips, tmp, job), name=f"perfbench-rank{r}")
                 for r in range(chips)]
        try:
            for p in procs:
                p.start()
            _wait(procs, tmp)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


def _wait(procs: list, tmp: str) -> None:
    """Return once every rank has ended with 0; raise ``Failure`` as soon
    as one ends otherwise, or when no rank has reached a new phase for
    ``STALL_S`` seconds."""
    from perfbench.harness import Failure

    last = time.time()
    while True:
        codes = [p.exitcode for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            raise Failure("rank(s) ended with exit codes " +
                          ", ".join(f"{r}: {c}" for r, c in bad))
        if all(c == 0 for c in codes):
            if not os.path.exists(os.path.join(tmp, "result.pkl")):
                raise Failure("rank 0 ended without a result")
            return
        phases = {}
        for r in range(len(procs)):
            path = os.path.join(tmp, f"beat{r}")
            try:
                last = max(last, os.path.getmtime(path))
                with open(path, encoding="utf-8") as f:
                    phases[r] = f.read()
            except OSError:
                phases[r] = "starting"
        if time.time() - last > STALL_S:
            raise Failure(f"no rank reached a new phase for {STALL_S:.0f} s; last phases: "
                          + ", ".join(f"{r}: {p}" for r, p in phases.items()))
        mp.connection.wait([p.sentinel for p in procs if p.exitcode is None], timeout=1.0)


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when the launcher ends (Linux)."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        return
    if os.getppid() != parent:
        os._exit(1)


def _rank(rank: int, chips: int, tmp: str, job: dict) -> None:
    """One rank: join the world, run the cell, hand rank 0's result back."""
    _die_with_parent(job["parent"])
    os.dup2(2, 1)   # the launcher alone prints to standard output
    sys.stdout = sys.stderr
    try:
        from perfbench import harness, sut

        torch.set_num_threads(job["threads"])
        cpu = job["device"] is not None and torch.device(job["device"]).type == "cpu"
        device = torch.device("cpu") if cpu else torch.device("cuda", rank)
        mesh = sut.join_mesh("file://" + os.path.join(tmp, "rendezvous"), rank, chips, device,
                             "gloo" if cpu else "nccl")
        group = Group(rank, chips, tmp, mesh)
        group.beat("joined")
        out = harness.run(job["root"], job["workload"], job["seed"], job["seconds"],
                          job["trace"], device=device, started=job["started"],
                          control=job["control"], group=group)
        if rank == 0:
            path = os.path.join(tmp, "result.pkl")
            with open(path + ".part", "wb") as f:
                pickle.dump(out, f)
            os.replace(path + ".part", path)
        group.beat("done")
    except BaseException:  # noqa: BLE001 - any failure ends the rank with a non-zero code
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stderr.flush()
    os._exit(0)
