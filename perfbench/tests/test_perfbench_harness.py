"""The harness on the CPU: BENCHMARK.json keeps to the contract's forms, a
configuration, a traffic mix and a per-layer metric added as new files only
are found and run, a broken timed path comes out not correct (an altered
answer, a replayed proof, the control, also across ranks), a traffic mix
the harness does not run is refused, nothing on the chip's path loads JAX
or the JAX package, and a run without a card prints no result."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from perfbench import harness, sut
from perfbench.control import break_witness
from perfbench.registry import Bench
from perfbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_forms():
    bench = Bench(tiny.REPO)
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(tiny.REPO, c["file"]))
        assert c["file"].startswith("perfbench/") and c["reduced"] == []
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(spec["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(bench.dir, "traffic", f"{w['traffic']}.json"))
        assert bench.traffic(w).get("sharded", False) == (w["chips"] > 1)
        e2e = {m["name"] for m in bench.metrics(w, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2 and bench.metrics(w, "per_layer")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert 1 <= spec["run_seconds"] <= 51


def test_per_layer_metrics_move_what_their_cells_report():
    bench = Bench(tiny.REPO)
    cells = {w["name"]: w for w in bench.spec["workloads"]}
    for m in bench.spec["per_layer"]:
        reader = bench.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.BETTER, reader.MOVES) == \
            (m["layer"], m["unit"], m["better"], m["moves"])
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in bench.metrics(cells[w], "end_to_end")}


def test_new_config_traffic_and_metric_as_new_files(tmp_path):
    root = tiny.checkout(str(tmp_path))
    with open(os.path.join(root, "perfbench/configs/dummy.json"), "w") as f:
        json.dump(dict(tiny.KEYLESS, name="dummy", num_constraints=24, num_private_vars=22,
                       nnz_total=160, nnz_max=70), f)
    with open(os.path.join(root, "perfbench/traffic/dummy-mix.json"), "w") as f:
        json.dump({"proof": "snark", "pcs": "hyrax", "loop": "closed", "provers": 1,
                   "reference_sample": 1}, f)
    with open(os.path.join(root, "perfbench/metrics/dummy_proofs.py"), "w") as f:
        f.write('LAYER = "entry"\nUNIT = "count"\nBETTER = "higher"\nMOVES = "prove_s"\n\n\n'
                'def read(bundle):\n    return float(len(bundle["proofs"]))\n')
    bench = tiny.read_bench(root)
    bench["configs"].append({"name": "dummy", "source": "test", "why": "test", "reduced": [],
                             "file": "perfbench/configs/dummy.json"})
    bench["workloads"].append({"name": "dummy.mix", "config": "dummy", "traffic": "dummy-mix",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy_proofs", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "entry",
                               "moves": "prove_s", "workloads": ["dummy.mix"]})
    tiny.write_bench(root, bench)
    plain = harness.run(root, "dummy.mix", 41, 0.2, False, device="cpu")
    reg = Bench(root)
    e2e = {m["name"] for m in reg.metrics(reg.cell("dummy.mix"), "end_to_end")}
    assert plain["correct"] and {"setup_s", "prove_s"} <= e2e - {"prove_peak_gb"} == set(
        plain["metrics"])
    traced = harness.run(root, "dummy.mix", 41, 0.2, True, device="cpu")
    assert traced["correct"]
    assert traced["metrics"]["dummy_proofs"]["value"] == traced["proofs"] >= 1
    assert list(traced)[-1] == "checks"


@pytest.mark.parametrize("cell", ["tiny.hyrax", "tiny.kzg", "tiny.nizk"])
def test_sound_run_is_correct(tmp_path, cell):
    root = tiny.checkout(str(tmp_path))
    out = harness.run(root, cell, 2**31 + 77, 0.2, False, device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["proofs"] >= 1
    reg = Bench(root)   # the CPU has no device peak to report
    assert set(out["metrics"]) == {m["name"] for m in reg.metrics(reg.cell(cell), "end_to_end")
                                   } - {"prove_peak_gb"}


def test_verify_time_is_a_layer_where_it_is_not_end_to_end(tmp_path):
    root = tiny.checkout(str(tmp_path))
    out = harness.run(root, "tiny.hyrax", 2**31 + 79, 0.2, True, device="cpu")
    assert out["correct"] and "verify_s" not in out["metrics"]
    each = out["verify_each_s"]
    assert out["metrics"]["verifier_s"]["value"] == pytest.approx(sum(each) / len(each))


@pytest.mark.parametrize("cell", ["tiny.hyrax", "tiny.kzg", "tiny.nizk"])
def test_answer_altered_where_produced_is_not_correct(tmp_path, cell, monkeypatch):
    prove = sut.Prover.prove
    warm_up = harness.tape_seed(8, "warm-up")

    def altered(self, tape_seed, vars_, inputs):
        proof = prove(self, tape_seed, vars_, inputs)
        if tape_seed == warm_up:    # set-up's proof stays sound: the window's are broken
            return proof
        ev = proof.r1cs_sat_proof.proof_eq_sc_phase2
        ev.z = (ev.z + 1) % harness_fr()
        return proof

    monkeypatch.setattr(sut.Prover, "prove", altered)
    out = harness.run(tiny.checkout(str(tmp_path)), cell, 8, 0.2, False, device="cpu")
    assert not out["correct"] and out["checks"]["rejected_proofs"]["value"] >= 1


@pytest.mark.parametrize("cell", ["tiny.hyrax", "tiny.kzg", "tiny.nizk"])
def test_replayed_proof_is_not_correct(tmp_path, cell, monkeypatch):
    """A prove that hands back the window's first proof again. Under the
    keyless cells the port's verifier rejects it for the next witness's
    input; the NIZK's witness never changes, so there each proof alone
    verifies and the repeated bytes are what is counted."""
    prove = sut.Prover.prove
    seen = []

    def replay(self, tape_seed, vars_, inputs):
        if len(seen) < 2:   # the warm-up's proof, then the window's first
            seen.append(prove(self, tape_seed, vars_, inputs))
        return seen[-1]

    monkeypatch.setattr(sut.Prover, "prove", replay)
    out = harness.run(tiny.checkout(str(tmp_path)), cell, 12, 8.0, False, device="cpu")
    assert out["attempted"] >= 2 and not out["correct"]
    if cell == "tiny.nizk":
        assert out["checks"]["duplicate_proofs"]["value"] == out["proofs"] - 1 >= 1
    else:
        assert out["checks"]["failed_iterations"]["value"] >= 1


def test_window_proves_a_witness_of_its_own_each_iteration(tmp_path, monkeypatch):
    prove = sut.Prover.prove
    proved = []

    def record(self, tape_seed, vars_, inputs):
        proved.append((id(vars_), inputs.assignment[0]))
        return prove(self, tape_seed, vars_, inputs)

    monkeypatch.setattr(sut.Prover, "prove", record)
    out = harness.run(tiny.checkout(str(tmp_path)), "tiny.hyrax", 13, 8.0, False, device="cpu")
    assert out["correct"] and out["proofs"] >= 2
    assert len({x for _, x in proved}) == len(proved)   # warm-up and window: inputs differ


def test_traffic_the_harness_does_not_run_is_refused(tmp_path):
    root = tiny.checkout(str(tmp_path))
    for key, value in (("provers", 2), ("loop", "open")):
        with open(os.path.join(root, "perfbench/traffic/hyrax.json")) as f:
            mix = json.load(f)
        mix[key] = value
        with open(os.path.join(root, "perfbench/traffic/hyrax.json"), "w") as f:
            json.dump(mix, f)
        with pytest.raises(harness.Failure):
            harness.run(root, "tiny.hyrax", 1, 0.1, False, device="cpu")
        mix.pop(key)
        with open(os.path.join(root, "perfbench/traffic/hyrax.json"), "w") as f:
            json.dump(mix, f)
    bench = tiny.read_bench(root)   # a sharded mix on one chip, an unsharded one on two
    for w in bench["workloads"]:
        if w["name"] in ("tiny.hyrax", "tiny.hyrax.mesh2"):
            w["traffic"] = {"hyrax": "hyrax-sharded", "hyrax-sharded": "hyrax"}[w["traffic"]]
    tiny.write_bench(root, bench)
    for cell in ("tiny.hyrax", "tiny.hyrax.mesh2"):
        with pytest.raises(harness.Failure):
            harness.run(root, cell, 1, 0.1, False, device="cpu")


@pytest.mark.parametrize("cell", ["tiny.hyrax", "tiny.nizk", "tiny.hyrax.mesh2"])
def test_control_is_not_correct(tmp_path, cell):
    out = harness.run(tiny.checkout(str(tmp_path)), cell, 9, 0.2, False, device="cpu",
                      control=break_witness(9))
    assert not out["correct"] and out["checks"]["rejected_proofs"]["value"] >= 1


def harness_fr() -> int:
    from perfbench.reference.bn254 import FR

    return FR


def _modules_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=tiny.REPO, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_chip_path_loads_no_jax(tmp_path):
    root = tiny.checkout(str(tmp_path))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from perfbench import harness\n"
            f"out = harness.run({root!r}, 'tiny.hyrax', 3, 0.1, True, device='cpu')\n"
            "assert out['correct']")
    mods = _modules_after(code)
    assert not mods & {"jax", "jaxlib", "flax", "spartan_tpu"}
    assert "spartan_tpu_torch" in mods


def test_reference_loads_nothing_of_either_package():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from perfbench import check\n"
            "from perfbench.reference import bn254, proof, r1cs, spartan, transcript")
    mods = _modules_after(code)
    assert not mods & {"jax", "jaxlib", "flax", "spartan_tpu", "spartan_tpu_torch", "torch"}


@pytest.mark.parametrize("cell", ["keyless.hyrax", "keyless.hyrax.mesh4"])
def test_no_card_no_result(tmp_path, cell):
    root = tiny.checkout(str(tmp_path))
    for cwd in (tiny.REPO, root):   # the checkout, and one without the program
        out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell,
                              "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""
