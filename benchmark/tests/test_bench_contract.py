"""BENCHMARK.json against the shape it must have, the whole-word import
check of the benchmark's sources, and the command's refusals."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from harness.imports import FORBIDDEN
from harness.spec import Spec

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    names = [e["name"] for g in ("configs", "workloads", "end_to_end", "per_layer") for e in b[g]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    # four cards only where what a cell measures exists across cards: a quarter of the cells
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    spec = Spec(ROOT)
    for cell in cells:
        e = {m["name"] for m in spec.metrics(cell, False)}
        assert "setup_s" in e and len(e) >= 2 and spec.metrics(cell, True)
        for m in spec.metrics(cell, True):  # each per-layer metric's cells report what it moves
            assert m["moves"] in e
    assert len(json.dumps(b)) < 64 * 1024


def test_lookup_by_name():
    spec = Spec(ROOT)
    for w in bench()["workloads"]:
        cfg = spec.config(w["config"])
        assert cfg["name"] == w["config"] and callable(spec.kernel(cfg["kernel"]))
        assert callable(spec.program(cfg["program"]).build)
        kind = spec.traffic(w["traffic"])["kind"]
        assert spec.kind(kind).kind == kind
    for m in bench()["end_to_end"] + bench()["per_layer"]:
        assert callable(spec.reader(m["name"]))
    with pytest.raises(KeyError):
        spec.cell("no_such_cell")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "_build" in path.parts or "_out" in path.parts:
            continue
        found = [n for n in _imports(path) if n.split(".", 1)[0] in FORBIDDEN]
        assert not found, f"{path}: {found}"


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for n in _imports(path):
            assert n.split(".", 1)[0] in {"math", "torch", "__future__"}, f"{path}: {n}"


def _run(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "real_solve_stream",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_command_refuses_without_a_device_or_the_port(tmp_path):
    """Without CUDA (this test's CPU) and in a directory holding only
    BENCHMARK.json and the benchmark, the command exits nonzero with no
    result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "_out", "__pycache__"))
    for cwd in (ROOT, tmp_path):
        out = _run(cwd, {"CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0 and out.stdout.strip() == ""
