"""The PyTorch port's examples that mirror the JAX package's
(``examples/use_hmatrix.py``, ``use_ddm_solver.py``, ``use_clustering.py``,
``compression_comparison.py``), each run with ``--device cpu`` at n ≤ 2,000
in a subprocess with a timeout: it must exit 0, print its results, and write
only into the directory it is given."""

import csv
import os
import subprocess
import sys

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import torch_parity  # noqa: F401  (the port's CPU tests ask for the CPU)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXAMPLES = {
    "torch_use_hmatrix": (["--n", "2000"], ["hmatrix_leaves.csv"], "matvec done"),
    "torch_use_ddm_solver": (["--n", "1000"], [], "two-level GenEO + GMRES"),
    "torch_use_clustering": (["--n", "2000"],
                             ["sphere_properties.csv", "sphere_tree.csv",
                              "sphere_clustered.csv"], "partition sizes: [500, 500, 500, 500]"),
    "torch_compression_comparison": (["--max-rank", "20"], ["compression_comparison.csv"],
                                     "SVD: rank 20 error"),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, files, says = EXAMPLES[name]
    outdir, cwd = tmp_path / "out", tmp_path / "cwd"
    cwd.mkdir()
    if files:
        args = args + ["--outdir", str(outdir)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    run = subprocess.run([sys.executable, os.path.join(ROOT, "examples", name + ".py"),
                          "--device", "cpu", *args], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=240)
    assert run.returncode == 0, run.stdout + run.stderr
    assert says in run.stdout, run.stdout
    assert not os.listdir(cwd)  # nothing written outside --outdir
    assert sorted(os.listdir(outdir)) == sorted(files) if files else not outdir.exists()
    if name == "torch_use_ddm_solver":
        assert run.stdout.count("'Converged': True") == 2, run.stdout
    if name == "torch_compression_comparison":
        with open(outdir / files[0]) as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 3 * 20
        last = {r["compressor"]: float(r["error"]) for r in rows if r["rank"] == "20"}
        assert max(last.values()) < 1e-2 and last["SVD"] <= last["partialACA"] * (1 + 1e-6)
