"""``torch_bench.py``, the port's run of ``bench.py``'s rows, on the CPU.

The rows that exercise the products (``kernel_smoke``, both ``matvec`` rows,
``complex_matvec_n100000``, ``weak_scaling_static``) run with ``--device
cpu --n 1500`` in one subprocess with a timeout, the others in
``tests/test_torch_bench_solvers.py`` (every row process imports torch anew,
which on the CPU takes seconds, so the rows are shared between the two
files): each row must exit clean with ``bench.py``'s metric keys (read from
``bench.py``'s source, not imported) and within its accuracy contract, and
nothing may be written outside ``--out``.  ``tests/test_torch_bench_weak.py``
holds ``weak_scaling_static`` against ``bench.py``'s own row."""

import ast
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ["kernel_smoke", "matvec_n10000", "matvec_n100000", "complex_matvec_n100000",
        "weak_scaling_static"]
# the files the harness must leave alone (bench.py's outputs, the baseline)
TRACKED = ["BENCH_AUX.json", "bench_iterations.json", "bench_baseline.json",
           "torch_bench_baseline.json"]
# bench.py's keys that name a JAX mechanism, and the port's key in their place
PORT_KEY = {"n_compile_events": "n_kernel_builds", "cache_dir": "kernel_build_dir"}
SMOKE_ROUTES = ["dense_tiled", "dense_tiled_trans", "lr_split_tiled", "complex_tiled",
                "dense_unplanned", "lr_unplanned"]
ENV = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")


def bench_keys() -> dict:
    """Row name -> the keys of the dict each ``_bench_*`` function of
    bench.py stores for it (``aux[...] = dict(...)``), from its source;
    ``per_P`` -> the keys of weak_scaling_static's entry per P."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn_rows = {"_bench_matvec": ["matvec_n10000", "matvec_n100000"],
               "_bench_complex_matvec": ["complex_matvec_n100000"],
               "_bench_blr2": ["blr2_n10000", "blr2_n100000"], "_bench_blr": ["blr_n10000"],
               "_bench_ddm": ["ddm_n100000"], "_bench_ddm_two_level": ["ddm2_n20000"],
               "_bench_weak_scaling_static": ["weak_scaling_static"],
               "_bench_assembly_cold": ["assembly_cold_n10000"]}
    keys = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in fn_rows:
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                        and isinstance(node.value, ast.Call)
                        and getattr(node.value.func, "id", None) == "dict"):
                    found = {PORT_KEY.get(k.arg, k.arg) for k in node.value.keywords}
                    target = node.targets[0].value.id
                    for row in fn_rows[fn.name] if target == "aux" else [target]:
                        keys["per_P" if row == "rows" else row] = found
    assert set(keys) == {r for rows in fn_rows.values() for r in rows} | {"per_P"}
    return keys


def run_bench(tmp_path, rows, n):
    """torch_bench.py on the CPU in a subprocess: (the finished process, the
    results it wrote to --out); asserts that it wrote nothing else."""
    out_dir, cwd = tmp_path / "out", tmp_path / "cwd"
    cwd.mkdir()
    before = {p: open(os.path.join(ROOT, p), "rb").read() for p in TRACKED
              if os.path.exists(os.path.join(ROOT, p))}
    run = subprocess.run([sys.executable, os.path.join(ROOT, "torch_bench.py"), "--device",
                          "cpu", "--n", str(n), "--rows", ",".join(rows), "--out",
                          str(out_dir / "aux.json")], cwd=cwd, env=ENV, capture_output=True,
                         text=True, timeout=150)
    assert not os.listdir(cwd) and os.listdir(out_dir) == ["aux.json"]
    after = {p: open(os.path.join(ROOT, p), "rb").read() for p in TRACKED
             if os.path.exists(os.path.join(ROOT, p))}
    assert after == before
    with open(out_dir / "aux.json") as f:
        return run, json.load(f)


def check_row(aux, name, n):
    """A row of a CPU run: bench.py's keys, its accuracy contract, reduced
    to n from its own size."""
    frag = aux[name]
    assert "error" not in frag, frag
    if name == "kernel_smoke":
        assert sorted(frag) == sorted(SMOKE_ROUTES)
        for route in frag.values():
            assert route["ok"] and route["rel_err"] < 1e-4 and route["wall_s"] > 0, route
            assert route["route"] == "plain" and route["launches"] == 0
        return
    keys = bench_keys()
    assert keys[name] <= set(frag), sorted(keys[name] - set(frag))
    assert frag["n"] == n and frag["reduced_from"] > n
    if name == "weak_scaling_static":
        assert sorted(frag["per_P"]) == ["1", "2", "4", "8"]
        assert all(set(v) == keys["per_P"] for v in frag["per_P"].values())
    for key in ("accuracy_ok", "converged"):
        assert frag.get(key, True) is True, (key, frag)


@pytest.fixture(scope="module")
def product_rows(tmp_path_factory):
    return run_bench(tmp_path_factory.mktemp("bench"), ROWS, 1500)


@pytest.mark.parametrize("name", ROWS)
def test_row_is_clean(product_rows, name):
    check_row(product_rows[1], name, 1500)


def test_run_streams_and_exits_clean(product_rows):
    run, aux = product_rows
    assert run.returncode == 0, run.stderr[-3000:]
    assert aux["violations"] == [] and aux["skipped"] == {} and aux["rows"] == ROWS
    assert aux["device"]["platform"] == "cpu"
    heads = [json.loads(line) for line in run.stdout.splitlines()]
    assert len(heads) == len(ROWS) + 1  # one after each row, one at the end
    assert heads[-1]["metric"] == "hmatrix_matvec_compressed_entries_per_s"
    assert heads[-1]["value"] == aux["matvec_n10000"]["compressed_entries_per_s"] > 0
    assert heads[-1]["vs_baseline"] is None and heads[-1]["device"] == "cpu"
