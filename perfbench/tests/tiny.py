"""Tiny cells for the CPU tests: a copy of the benchmark in a temporary
checkout, with configurations small enough to prove on the CPU; the mesh
cell runs as 2 gloo ranks on the CPU."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KEYLESS = {"name": "tiny-keyless", "generator": "keyless_circom", "num_constraints": 40,
           "num_private_vars": 36, "num_public_inputs": 1, "nnz_total": 260, "nnz_max": 120,
           "structure_seed": 5, "reduced": []}
SYNTH = {"name": "tiny-synth", "generator": "spartan_synthetic", "num_cons": 64,
         "num_vars": 64, "num_inputs": 10, "reduced": []}


def checkout(tmp: str) -> str:
    """A checkout at ``tmp`` holding this repository's BENCHMARK.json and
    perfbench/, plus the tiny configurations and their cells."""
    shutil.copytree(os.path.join(REPO, "perfbench"), os.path.join(tmp, "perfbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    for cfg in (KEYLESS, SYNTH):
        path = f"perfbench/configs/{cfg['name']}.json"
        with open(os.path.join(tmp, path), "w", encoding="utf-8") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": cfg["name"], "source": "test", "file": path,
                                 "reduced": [], "why": "test"})
    for name, config, traffic, chips, like in (
            ("tiny.hyrax", "tiny-keyless", "hyrax", 1, "keyless.hyrax"),
            ("tiny.kzg", "tiny-keyless", "kzg", 1, "keyless.kzg"),
            ("tiny.nizk", "tiny-synth", "nizk", 1, "spartan-synth20.nizk"),
            ("tiny.hyrax.mesh2", "tiny-keyless", "hyrax-sharded", 2, "keyless.hyrax.mesh4")):
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": chips, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    write_bench(tmp, bench)
    return tmp


def read_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def write_bench(root: str, bench: dict) -> None:
    with open(os.path.join(root, "BENCHMARK.json"), "w", encoding="utf-8") as f:
        json.dump(bench, f, indent=1)
