"""A cell across several chips, on the CPU: the tiny mesh cell runs as 2
gloo ranks. Its result is printed once, by the launcher, correct, with every
rank's proofs the same bytes; a rank whose proofs differ, the exchange
between ranks left out, a rank that raises and a rank that hangs each come
out as they must (the control is a case of ``test_perfbench_harness.py``'s);
a cell on one chip starts no process and makes no collective; and
``collective_s`` reads a hand-made event list."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from perfbench import harness, ranks
from perfbench.registry import Bench
from perfbench.tests import tiny

MESH = "tiny.hyrax.mesh2"


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


class _Pool:
    """The pool of a rank, whose witnesses after the warm-up's ``act`` on
    rank 1: "raise", or "hang"."""

    def __init__(self, pool, act: str):
        self.pool, self.act = pool, act

    def __len__(self) -> int:
        return len(self.pool)

    def __getitem__(self, j: int):
        if j and _rank() == 1:
            if self.act == "raise":
                raise RuntimeError("rank 1 fails on purpose")
            time.sleep(3600)
        return self.pool[j]


class _OnRank1:
    """A control hook for ``harness.run``; it pickles, so every rank gets it."""

    def __init__(self, act: str):
        self.act = act

    def __call__(self, pool):
        if self.act == "alter proofs":
            if _rank() == 1:
                from perfbench import sut

                proof_bytes = sut.Prover.proof_bytes
                sut.Prover.proof_bytes = staticmethod(lambda p: proof_bytes(p)[:-1] + b"\x01")
            return pool
        return _Pool(pool, self.act)


class _Sharded:
    """A control hook that lowers the port's host-path threshold in each
    rank, so that the tiny cell's sumchecks take the mesh branches and their
    all-reduces; with ``drop``, each all-reduce of the port is left out."""

    def __init__(self, drop: bool):
        self.drop = drop

    def __call__(self, pool):
        import torch.distributed as dist

        from spartan_tpu_torch.core import hostpath as HP

        HP.HOST_N = 4
        if self.drop:
            dist.all_reduce = lambda *_, **__: None
        return pool


def test_mesh_result_is_printed_once_and_every_rank_agrees(tmp_path):
    root = tiny.checkout(str(tmp_path))
    code = ("import json, sys; sys.path.insert(0, '.')\n"
            "import torch; torch.set_num_threads(2)\n"
            "from perfbench import harness\n"
            f"out = harness.run({root!r}, {MESH!r}, 2**31 + 97, 0.2, False, device='cpu')\n"
            "print(json.dumps(out))")
    done = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-4000:]
    lines = done.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["correct"] and out["failed"] == 0 and out["proofs"] >= 1
    assert out["device"]["count"] == 2
    assert [r["backend"] for r in out["ranks"]] == ["gloo", "gloo"]
    assert out["checks"]["rank_proofs_differ"] == {"value": 0, "limit": 0}
    assert list(out)[-1] == "checks"
    reg = Bench(root)
    assert set(out["metrics"]) == {m["name"] for m in reg.metrics(reg.cell(MESH), "end_to_end")
                                   } - {"prove_peak_gb"}


def test_proofs_that_differ_between_ranks_are_not_correct(tmp_path):
    out = harness.run(tiny.checkout(str(tmp_path)), MESH, 21, 0.2, False, device="cpu",
                      control=_OnRank1("alter proofs"))
    assert not out["correct"]
    assert out["checks"]["rank_proofs_differ"]["value"] == out["proofs"] >= 1
    assert out["checks"]["rejected_proofs"]["value"] == 0   # rank 0's proofs are sound


def test_exchange_between_ranks_left_out_gives_no_result(tmp_path):
    """The sharded path, sound, is correct; without its all-reduces each
    rank proves from its own shard's sums, the port's prover stops on its
    own check, and the run ends without a result."""
    root = tiny.checkout(str(tmp_path))
    out = harness.run(root, MESH, 41, 0.2, False, device="cpu", control=_Sharded(False))
    assert out["correct"] and out["checks"]["rank_proofs_differ"]["value"] == 0
    with pytest.raises(harness.Failure):
        harness.run(root, MESH, 41, 0.2, False, device="cpu", control=_Sharded(True))


@pytest.mark.parametrize("act, stall_s", [("raise", ranks.STALL_S), ("hang", 5.0)])
def test_failed_rank_ends_the_run_without_a_result(tmp_path, monkeypatch, act, stall_s):
    monkeypatch.setattr(ranks, "STALL_S", stall_s)
    root = tiny.checkout(str(tmp_path))
    t = time.perf_counter()
    with pytest.raises(harness.Failure):
        harness.run(root, MESH, 31, 2.0, False, device="cpu", control=_OnRank1(act))
    assert time.perf_counter() - t < 50


def test_one_chip_cell_starts_no_process_and_makes_no_collective(tmp_path, monkeypatch):
    import multiprocessing

    import torch.distributed as dist

    def refuse(*_, **__):
        raise AssertionError("a one-chip cell reached the ranks' machinery")

    monkeypatch.setattr(ranks, "launch", refuse)
    monkeypatch.setattr(ranks.Group, "__init__", refuse)
    monkeypatch.setattr(multiprocessing, "get_context", refuse)
    for name in ("init_process_group", "new_group", "barrier", "broadcast", "all_reduce",
                 "all_gather", "all_gather_object"):
        monkeypatch.setattr(dist, name, refuse)
    out = harness.run(tiny.checkout(str(tmp_path)), "tiny.hyrax", 2**31 + 99, 0.2, False,
                      device="cpu")
    assert out["correct"] and "ranks" not in out
    assert "rank_proofs_differ" not in out["checks"]
    assert not dist.is_initialized()


def test_collective_seconds_on_a_hand_made_event_list():
    reader = Bench(tiny.REPO).metric_reader("collective_s")
    events = [("perfbench.prove", False, 0.0, 10e6), ("perfbench.verify", False, 10e6, 12e6),
              ("perfbench.prove", False, 12e6, 20e6),
              ("ncclDevKernel_AllReduce_Sum_u64_RING_LL", True, 1e6, 3e6),
              ("ncclDevKernel_AllGather_RING_LL", True, 2e6, 4e6),      # overlaps: 1 s to 4 s
              ("ncclDevKernel_Broadcast_RING_LL", True, 11e6, 13e6),    # half in a verify
              ("nccl:all_reduce", False, 5e6, 6e6),                     # the host's record
              ("msm_bucket_tiles_kernel", True, 5e6, 9e6)]
    bundle = {"proofs": [{}, {}], "trace": {"events": events}}
    assert reader.read(bundle) == pytest.approx((3.0 + 1.0) / 2)
    one_card = {"proofs": [{}], "trace": {"events": [e for e in events
                                                    if not e[0].startswith("nccl")]}}
    assert reader.read(one_card) is None
    assert reader.read({"proofs": [], "trace": {}}) is None
