"""The bullet reduction's per-layer metrics, ``bullet_s`` and
``bullet_device_rounds``, on hand-made span trees: a proof whose
reductions ran all on the host counts 0 device rounds, a program without
``bullet.reduce`` spans reads nothing. Traced runs of the tiny cells report
them among the span metrics (``test_perfbench_span_metrics.py``)."""

from __future__ import annotations

from perfbench.registry import Bench
from perfbench.tests import tiny

NEW = ("bullet_s", "bullet_device_rounds")


def _proof(*labels):
    return {"spans": [(1, label, 0.5) for label in labels], "kernels": []}


def test_readers_on_span_trees():
    bench = Bench(tiny.REPO)
    seconds, rounds = (bench.metric_reader(name) for name in NEW)
    on_card = _proof("bullet.device_round", "bullet.device_round", "bullet.reduce",
                     "bullet.host_msm", "bullet.host_tail", "bullet.reduce")
    on_host = _proof("bullet.host_msm", "bullet.host_tail", "bullet.reduce")
    assert rounds.read({"proofs": [on_card, on_host]}) == 1.0
    assert rounds.read({"proofs": [on_host]}) == 0
    assert seconds.read({"proofs": [on_card, on_host]}) == 0.75
    parent = {"proofs": [_proof("bullet.host_msm", "bullet.host_tail")]}
    assert rounds.read(parent) is None and seconds.read(parent) is None
