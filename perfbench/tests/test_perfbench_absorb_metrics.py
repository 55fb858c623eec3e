"""``bulk_absorbs``, the transcript's native absorbs of long messages per
proof: on hand-made span lists, and in traced runs of the tiny cells, where
the NIZK absorbs its shape digest in one native call and the SNARK's
appends, all shorter than a STROBE block, take none."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.registry import Bench
from perfbench.tests import tiny


def _proof(*labels):
    return {"spans": [(1, label, 0.5) for label in labels], "kernels": []}


def test_reader_on_span_lists():
    read = Bench(tiny.REPO).metric_reader("bulk_absorbs").read
    one = _proof("NIZK::prove", "shape_digest_absorb", "strobe.bulk_absorb")
    assert read({"proofs": [one, one]}) == 1.0
    assert read({"proofs": [_proof("SNARK::prove", "bullet.reduce")]}) == 0
    assert read({"proofs": [one, _proof("NIZK::prove")]}) == 0.5
    assert read({"proofs": []}) is None


@pytest.mark.parametrize("cell, want", [("tiny.nizk", 1.0), ("tiny.hyrax", 0.0)])
def test_traced_run_reports_bulk_absorbs(tmp_path, cell, want):
    root = tiny.checkout(str(tmp_path))
    out = harness.run(root, cell, 2**31 + 17, 0.2, True, device="cpu")
    assert out["correct"] and out["proofs"] >= 1
    assert out["metrics"]["bulk_absorbs"] == {"value": want, "unit": "absorbs"}
