"""The per-layer metrics that read the program's span tree, on the CPU: a
traced run of each tiny cell, the mesh cell's 2 gloo ranks among them,
reports every one that lists the cell it stands for, each at least 0, the
prove's own seconds no more than its root span, and the bullet reductions
with time and, on the CPU, no round on a card."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.registry import Bench
from perfbench.tests import tiny

SPAN_METRICS = ("matrix_upload_s", "witness_encode_s", "digest_absorb_s", "addr_ts_tables_s",
                "bullet_host_msm_s", "prove_self_s", "bullet_s", "bullet_device_rounds")
LIKE = {"tiny.hyrax": "keyless.hyrax", "tiny.kzg": "keyless.kzg",
        "tiny.nizk": "spartan-synth20.nizk", "tiny.hyrax.mesh2": "keyless.hyrax.mesh4"}
ROOT = {"tiny.hyrax": "SNARK::prove", "tiny.kzg": "SNARK::prove", "tiny.nizk": "NIZK::prove",
        "tiny.hyrax.mesh2": "SNARK::prove"}


@pytest.mark.parametrize("cell", sorted(LIKE))
def test_traced_run_reports_the_span_metrics(tmp_path, cell):
    root = tiny.checkout(str(tmp_path))
    spec = {m["name"]: m for m in Bench(root).spec["per_layer"]}
    want = {name for name in SPAN_METRICS if LIKE[cell] in spec[name]["workloads"]}
    assert want and all(spec[name]["workloads"] for name in SPAN_METRICS)
    out = harness.run(root, cell, 2**31 + 91, 0.2, True, device="cpu")
    assert out["correct"] and out["proofs"] >= 1
    got = {k: v["value"] for k, v in out["metrics"].items() if k in SPAN_METRICS}
    assert set(got) == want
    assert all(v >= 0 for v in got.values())
    roots = [p[ROOT[cell]] for p in out["spans_each_s"]]
    assert got["prove_self_s"] <= sum(roots) / len(roots)
    assert got["bullet_s"] > 0 and got["bullet_device_rounds"] == 0
