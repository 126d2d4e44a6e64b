"""The command on a CUDA device: one short run of a cell, correct, with the
result's keys.  Marked ``chip``; skips where there is no CUDA device."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_chip(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "real_solve_stream",
                          "--seed", str(2**31 + 11), "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert list(r)[-1] == "checks"
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert 0 < r["metrics"]["product_roofline.solve"]["value"] <= 100
    else:
        assert {"solve_ms", "solve_ms_p95", "peak_mem_gb", "setup_s"} <= set(r["metrics"])
