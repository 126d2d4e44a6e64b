"""The command on a CUDA device: one short run of a cell, correct, with the
result's keys; and a throwaway cell on two cards, one rank a card.  Marked
``chip``; skips where there is no CUDA device, or for the two-card cell
fewer than two."""

import json
import os
import subprocess
import sys

import pytest

from harness.spec import Spec

from conftest import ROOT, add_cell, copy_benchmark


def _run(cwd, cell, seed, trace, seconds=2):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                          cwd=cwd, capture_output=True, text=True, timeout=1200)


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_chip(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _run(ROOT, "real_solve_stream", 2**31 + 11, trace)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    chips = Spec(ROOT).cell("real_solve_stream")["chips"]
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["count"] == chips
    assert list(r)[-1] == "checks"
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert 0 < r["metrics"]["product_roofline.solve"]["value"] <= 100
    else:
        assert {"solve_ms", "solve_ms_p95", "peak_mem_gb", "setup_s"} <= set(r["metrics"])


@pytest.mark.chip
def test_a_cell_on_two_cards(tmp_path):
    """A throwaway cell with ``chips`` 2 (the real sphere at n = 20,000, two
    partitions, ``dist_ddm_solver``) in a copy of the checkout: one result
    line, from rank 0, correct, ``count`` 2 and the larger of the cards'
    peaks."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    root = copy_benchmark(tmp_path)
    os.symlink(ROOT / "htool_tpu_torch", root / "htool_tpu_torch")
    (ROOT / "benchmark/_build").mkdir(exist_ok=True)
    os.symlink(ROOT / "benchmark/_build", root / "benchmark/_build")  # the checkout's kernels
    cfg = json.loads((root / "benchmark/configs/sphere_laplace_f32_n100k.json").read_text())
    cfg.update(name="dist2_throwaway", n=20000, program="dist_ddm_solver", tiled_matvec=False,
               tree=dict(cfg["tree"], n_partitions=2))
    add_cell(root, cfg, "dist2_stream", 2)
    out = _run(root, "dist2_stream", 2**31 + 13, 1)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1 and out.stdout.strip().splitlines()[-1] == lines[0]
    r = json.loads(lines[0])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["count"] == 2
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    peaks = [line for line in out.stderr.splitlines() if line.startswith("peak_bytes by rank ")]
    by_rank = json.loads(peaks[-1].removeprefix("peak_bytes by rank "))
    assert len(by_rank) == 2 and r["device"]["memory_peak_bytes"] == max(by_rank)
