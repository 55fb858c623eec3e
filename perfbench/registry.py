"""Finding a cell's pieces by the names ``BENCHMARK.json`` gives them.

A configuration is the JSON file its ``configs`` entry names; a traffic
mix is ``perfbench/traffic/<traffic>.json``; an input generator is
``perfbench/gen/<generator>.py`` (the configuration's ``generator``); a
per-layer metric is ``perfbench/metrics/<name>.py``. Modules are loaded
from their files, so a new one needs no edit of any file already here.
"""

from __future__ import annotations

import importlib.util
import json
import os

def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` of the checkout at ``root``."""

    def __init__(self, root: str):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        self.dir = os.path.join(root, "perfbench")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == cell["config"]:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return load_json(os.path.join(self.dir, "traffic", f"{cell['traffic']}.json"))

    def generator(self, config: dict):
        name = config["generator"]
        return load_module(os.path.join(self.dir, "gen", f"{name}.py"), f"perfbench_gen_{name}")

    def metric_reader(self, name: str):
        return load_module(os.path.join(self.dir, "metrics", f"{name}.py"),
                           f"perfbench_metric_{name}")

    def metrics(self, cell: dict, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]
