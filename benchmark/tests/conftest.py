"""CPU tests of the benchmark's harness: ``python -m pytest benchmark/tests``
from the root of the repository.  Tests marked ``chip`` need a CUDA device
and skip without one; they decide so inside the test."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a small copy of each configuration, for the CPU: the sizes of the sphere and
# its tree cut so that a run takes seconds; every other setting as configured
TINY = {"n": 1500, "tree": {"max_leaf_size": 64, "n_partitions": 8},
        "solver": {"overlap_radius": 0.1}}


def shrink(cfg: dict, cuts: dict) -> dict:
    """``cfg`` with ``cuts`` applied, a group's keys one by one."""
    out = dict(cfg)
    for key, value in cuts.items():
        out[key] = dict(cfg[key], **value) if isinstance(value, dict) else value
    return out


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skips without one")


def copy_benchmark(dst: Path) -> Path:
    """BENCHMARK.json and the benchmark's files (not its build or outputs)
    under ``dst``, which then serves as a checkout's root."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(BENCH, dst / BENCH.name,
                    ignore=shutil.ignore_patterns("_build", "_out", "tests", "__pycache__"))
    return dst


def add_tiny_cells(root: Path) -> dict:
    """A tiny copy of every configuration and cell, added as files and
    entries; returns {cell: tiny cell}."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    names = {}
    for c in list(bench["configs"]):
        cfg = shrink(json.loads((root / c["file"]).read_text()), TINY)
        cfg["name"] = "tiny_" + c["name"]
        path = f"{BENCH.name}/configs/tiny_{c['name']}.json"
        (root / path).write_text(json.dumps(cfg))
        bench["configs"].append(dict(c, name=cfg["name"], file=path))
    for w in list(bench["workloads"]):
        tiny = dict(w, name="tiny_" + w["name"], config="tiny_" + w["config"])
        bench["workloads"].append(tiny)
        names[w["name"]] = tiny["name"]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(tiny["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return names


def add_cell(root: Path, cfg: dict, cell: str, chips: int, like: str = "real_solve_stream") -> None:
    """The configuration ``cfg`` (its ``name``) and a cell ``cell`` of it under
    ``like``'s traffic, on ``chips`` cards, added as files and entries to the
    copy at ``root``; the cell reports the metrics ``like`` reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    path = f"{BENCH.name}/configs/{cfg['name']}.json"
    (root / path).write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][0], name=cfg["name"], file=path))
    traffic = next(w["traffic"] for w in bench["workloads"] if w["name"] == like)
    bench["workloads"].append({"name": cell, "config": cfg["name"], "traffic": traffic,
                               "chips": chips, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """(root, {cell: tiny cell}) of a copy of the benchmark with tiny cells."""
    root = copy_benchmark(tmp_path_factory.mktemp("bench"))
    return root, add_tiny_cells(root)


@pytest.fixture(scope="session")
def cpu():
    import torch

    return torch.device("cpu")
