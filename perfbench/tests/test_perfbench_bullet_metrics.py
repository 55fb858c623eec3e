"""The bullet reduction's per-layer metrics: ``bullet_s`` and
``bullet_device_rounds`` on hand-made span trees (a proof whose
reductions ran all on the host counts 0 device rounds, a program without
``bullet.reduce`` spans reads nothing), and in a traced run of each tiny
cell, where the CPU keeps every round on the host."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.registry import Bench
from perfbench.tests import tiny

NEW = ("bullet_s", "bullet_device_rounds")
CELLS = {"tiny.hyrax": "keyless.hyrax", "tiny.kzg": "keyless.kzg",
         "tiny.nizk": "spartan-synth20.nizk"}


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


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_run_reports_the_bullet_metrics(tmp_path, cell):
    root = tiny.checkout(str(tmp_path))
    spec = {m["name"]: m for m in Bench(root).spec["per_layer"]}
    assert all(CELLS[cell] in spec[name]["workloads"] for name in NEW)
    out = harness.run(root, cell, 2**31 + 93, 0.2, True, device="cpu")
    assert out["correct"] and out["proofs"] >= 1
    got = {k: v["value"] for k, v in out["metrics"].items() if k in NEW}
    assert set(got) == set(NEW)
    assert got["bullet_s"] > 0 and got["bullet_device_rounds"] == 0
