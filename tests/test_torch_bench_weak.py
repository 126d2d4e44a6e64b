"""``torch_bench.py``'s ``weak_scaling_static`` against ``bench.py``'s own.

At n = 2,000 on the CPU, ``python bench.py --row weak_scaling_static`` (in a
subprocess: importing bench.py would rewrite ``XLA_FLAGS`` in this process)
and the port's row must give equal entries for every partition count and
key, with both trees built by the same backend (the native planner, or
NumPy where it did not build)."""

import json
import subprocess
import sys

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_bench import ROOT, ENV, run_bench  # noqa: E402

# bench.py's row, and the backend its process built its trees with
_REFERENCE = """\
import atexit, runpy, sys
def report():
    m = sys.modules.get('htool_tpu.native')
    print('TREE_BACKEND', 'native' if m is not None and m._lib is not None else 'python')
atexit.register(report)
sys.argv = ['bench.py', '--row', 'weak_scaling_static']
runpy.run_path('bench.py', run_name='__main__')
"""


def test_weak_scaling_equals_bench_py(tmp_path):
    env = dict(ENV, BENCH_N="2000", JAX_PLATFORMS="cpu",
               HTOOL_TPU_COMPILE_CACHE=str(tmp_path / "cache"))
    ref = subprocess.run([sys.executable, "-c", _REFERENCE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=150)
    assert ref.returncode == 0, ref.stderr[-3000:]
    lines = ref.stdout.splitlines()
    payload = json.loads(next(l for l in lines if l.startswith("##BENCH_ROW_RESULT## "))
                         .split(" ", 1)[1])
    want = payload["aux"]["weak_scaling_static"]
    backend = next(l for l in lines if l.startswith("TREE_BACKEND")).split()[1]

    run, aux = run_bench(tmp_path, ["weak_scaling_static"], 2000)
    assert run.returncode == 0, run.stderr[-3000:]
    got = aux["weak_scaling_static"]
    assert got["tree_backend"] == backend
    assert got["n"] == want["n"] == 2000
    assert got["per_P"] == want["per_P"]
