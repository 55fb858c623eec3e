"""The port's span tree (``utils/timer.py``), on the CPU.

(a) Off (neither enabled nor collecting) a nested tree of Timers calls the
    device sync 0 times and records nothing; (b) collecting, ``records()``
    keeps its (depth, label, seconds) triples in stop order, and the tree's
    parents, starts and ends nest; (c) under ``torch.profiler`` the spans
    are one flat track of ranges, each named by the innermost running
    span, starting with it; (d) a span opened while off leaves no record;
    (e) tiny SNARK (Hyrax, KZG) and NIZK proves while collecting carry the
    spans the benchmark reads, with no label inside itself and every span
    inside its parent.
"""

import time

import pytest
import torch

from spartan_tpu_torch.utils import timer as T
from spartan_tpu_torch.utils.timer import Timer

from torch_threads import _one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Printing off, collection off and the accumulators empty before and
    after, and the device sync counted (the module's one intra-op thread
    comes from ``torch_threads``)."""
    monkeypatch.setattr(Timer, "_enabled", False)
    syncs = []
    monkeypatch.setattr(T, "_sync", lambda: syncs.append(1))
    Timer.collect(False)
    Timer.acc_reset()   # accumulators another test file left in this worker
    yield syncs
    Timer.collect(False)
    Timer.acc_reset()


def _three_levels(pause: float = 0.0):
    """a(b(c), d), each span's own work ``pause`` seconds."""
    with Timer("a"):
        time.sleep(pause)
        with Timer("b"):
            time.sleep(pause)
            with Timer("c"):
                time.sleep(pause)
            time.sleep(pause)
        d = Timer("d")
        time.sleep(pause)
        d.stop()
        time.sleep(pause)


def test_off_costs_nothing(_clean):
    syncs = _clean
    _three_levels()
    lap = Timer.laps("zk_x")
    lap()
    lap("evals")
    assert syncs == [] and Timer.records() == [] and Timer.tree() == []
    assert Timer._open == [] and Timer.acc_records() == []


def test_records_keep_their_triples(_clean):
    syncs = _clean
    Timer.collect()
    _three_levels()
    recs, tree = Timer.records(), Timer.tree()
    assert [(d, lbl) for d, lbl, _ in recs] == [(2, "c"), (1, "b"), (1, "d"), (0, "a")]
    assert [s.label for s in tree] == ["c", "b", "d", "a"]
    assert [dt for _, _, dt in recs] == [(s.end_ns - s.start_ns) / 1e9 for s in tree]
    by = {s.label: s for s in tree}
    assert by["a"].parent is None and by["b"].parent == by["d"].parent == by["a"].id
    assert by["c"].parent == by["b"].id
    for s in tree:
        if s.parent is not None:
            p = next(q for q in tree if q.id == s.parent)
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert by["b"].end_ns <= by["d"].start_ns
    assert len(syncs) == 2 * len(tree)   # collecting keeps the sync at start and stop
    lap = Timer.laps("zk_x")
    lap("evals")
    assert [lbl for lbl, _ in Timer.acc_records()] == ["zk_x/evals"]


def test_profiler_track_is_flat():
    from torch.profiler import ProfilerActivity, profile

    labels = {"a", "b", "c", "d"}
    Timer.collect()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _three_levels(pause=0.005)
    tree = Timer.tree()
    ranges = sorted((ev.start_ns(), ev.end_ns(), ev.name())
                    for ev in prof.profiler.kineto_results.events() if ev.name() in labels)
    for (_, e0, _), (s1, _, _) in zip(ranges, ranges[1:]):
        assert e0 <= s1
    # the innermost running span at each range's midpoint is the range's label
    for s, e, name in ranges:
        mid = (s + e) // 2
        inner = [x for x in tree if x.start_ns <= mid <= x.end_ns]
        assert max(inner, key=lambda x: x.start_ns).label == name
    assert [n for _, _, n in ranges] == ["a", "b", "c", "b", "a", "d", "a"]
    for x in tree:
        first = min(s for s, _, n in ranges if n == x.label)
        assert abs(first - x.start_ns) < 1_000_000


def test_span_opened_off_is_dropped():
    outer = Timer("outer")
    Timer.collect()
    with Timer("inner"):
        pass
    outer.stop()
    assert [(d, lbl) for d, lbl, _ in Timer.records()] == [(0, "inner")]
    assert Timer.tree()[0].parent is None


def _nested_in_itself(tree) -> list:
    by = {s.id: s for s in tree}
    bad = []
    for s in tree:
        p = s.parent
        while p is not None:
            if by[p].label == s.label:
                bad.append(s.label)
            p = by[p].parent
    return bad


def _check_tree(tree, root: str, want: set):
    by = {s.id: s for s in tree}
    roots = [s for s in tree if s.parent is None]
    assert [s.label for s in roots] == [root]
    assert want <= {s.label for s in tree}, want - {s.label for s in tree}
    assert _nested_in_itself(tree) == []
    for s in tree:
        if s.parent is not None:
            p = by[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


SNARK_SPANS = {"R1CSProof::prove", "R1CSShape::evaluate", "R1CSEvalProof::prove",
               "witness_encode", "matrix_device_copy", "addr_ts_tables", "bullet.host_tail",
               "bullet.host_msm"}


@pytest.mark.parametrize("kind", ["hyrax", "kzg", "nizk"])
def test_prove_spans(kind):
    from spartan_tpu_torch.io.keyless_bench import synthetic
    from spartan_tpu_torch.snark import NIZK, SNARK, NIZKGens, SNARKGens
    from spartan_tpu_torch.utils.random_tape import RandomTape
    from spartan_tpu_torch.utils.transcript import Transcript

    inst, vars_, inputs, nnz = synthetic(3, seed=7)
    n = inst.inst.num_cons
    tape = RandomTape(b"proof", seed=bytes([3]) * 32)
    if kind == "nizk":
        gens = NIZKGens(n, n, 1, device="cpu")
        Timer.collect()
        proof = NIZK.prove(inst, vars_, inputs, gens, Transcript(b"t"), tape)
        _check_tree(Timer.tree(), "NIZK::prove",
                    {"shape_digest_absorb", "R1CSProof::prove", "witness_encode",
                     "matrix_device_copy", "bullet.host_tail", "bullet.host_msm"})
        Timer.collect()
        proof.verify(inst, inputs, Transcript(b"t"), gens)
        _check_tree(Timer.tree(), "NIZK::verify", {"shape_digest_absorb"})
        return
    srs = None
    if kind == "kzg":
        from spartan_tpu_torch.pcs.kzg import KZGSrs

        srs = KZGSrs.setup_from_seed(8 * 32 + 1, 11, device="cpu")
    gens = SNARKGens(n, n, 1, nnz, pcs=kind, kzg_srs=srs, device="cpu")
    Timer.collect()
    comm, decomm = SNARK.encode(inst, gens)
    _check_tree(Timer.tree(), "SNARK::encode", {"matrix_device_copy"})
    Timer.collect()
    proof = SNARK.prove(inst, comm, decomm, vars_, inputs, gens, Transcript(b"t"), tape)
    _check_tree(Timer.tree(), "SNARK::prove", SNARK_SPANS)
    Timer.collect()
    proof.verify(comm, inputs, Transcript(b"t"), gens)
    _check_tree(Timer.tree(), "SNARK::verify", set())
