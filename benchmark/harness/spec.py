"""``BENCHMARK.json`` and the files it names, found by name.

Everything of one configuration, traffic mix or metric sits in files of its
own under the benchmark's directory:

- ``BENCHMARK.json`` names each configuration's file (``configs/<name>.json``);
- a configuration names its kernel formula, ``reference/<kernel>.py``, and
  the adapter that drives the program, ``programs/<program>.py`` (a class
  ``Program``);
- a traffic mix is ``traffic/<mix>.json``, and names its kind, whose loop
  is ``kinds/<kind>.py`` (a class ``Loop``);
- a metric's reader is ``metrics/<metric>.py``, a function ``read(record)``.

So a cell, configuration, mix or metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = "benchmark"


def _load_module(path: Path, prefix: str):
    name = f"{prefix}_{re.sub(r'[^0-9A-Za-z_]', '_', path.stem)}"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / BENCH_DIR
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    @staticmethod
    def _named(entries, name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._named(self.bench["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.bench["configs"], name, "config")
        with open(self.root / entry["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def kernel(self, name: str):
        """The kernel function ``kernel(x, y)`` of ``reference/<name>.py``."""
        return _load_module(self.dir / "reference" / f"{name}.py", "bench_kernel").kernel

    def kind(self, name: str):
        """The loop of a traffic kind: ``Loop`` of ``kinds/<name>.py``."""
        return _load_module(self.dir / "kinds" / f"{name}.py", "bench_kind").Loop

    def program(self, name: str):
        """The adapter of a program: ``Program`` of ``programs/<name>.py``."""
        return _load_module(self.dir / "programs" / f"{name}.py", "bench_program").Program

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: those that list the cell, or list no cells."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return _load_module(self.dir / "metrics" / f"{metric}.py", "bench_metric").read
