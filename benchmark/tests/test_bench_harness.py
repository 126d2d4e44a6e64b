"""The harness driven end to end on the CPU at a tiny size, without the
look for a chip: a sound run is correct, a run with its timed path broken
underneath is not, and a cell added as files alone runs."""

import json
import time

import pytest
import torch

from harness import imports, runner
from harness.spec import Spec

# the benchmark's cells
CELLS = ["real_solve_stream", "real_new_problem"]


def run_tiny(root, cell, trace=False, seconds=0.5, seed=2**33 + 17):
    import htool_tpu_torch  # noqa: F401  (the port is imported before the clock starts)

    return runner.run(Spec(root), cell, seed, seconds, trace, torch.device("cpu"),
                      time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run(tiny_root, cell, trace):
    root, tiny = tiny_root
    r = run_tiny(root, tiny[cell], trace)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"residual", "product_err", "unconverged"}
    spec = Spec(root)
    want = {m["name"] for m in spec.metrics(tiny[cell], trace)}
    # a device metric reads nothing on the CPU, and is left out of the line; so
    # is the count of CG steps replayed from CUDA graphs, which the CPU never captures
    device_only = {"peak_mem_gb", "device_idle.problem", "device_idle.solve",
                   "product_roofline.solve", "graph_steps.solve"}
    assert set(r["metrics"]) == want - device_only
    for m in r["metrics"].values():
        assert m["value"] > 0
    json.loads(json.dumps(r))
    if trace:
        assert r["device"]["window_s"] > 0 and "breakdown" in r


def _broken(monkeypatch, fault):
    """Break ``DDMSolver.solve`` underneath the harness."""
    from htool_tpu_torch.solvers.ddm import DDMSolver

    solve = DDMSolver.solve

    def broken(self, b, *args, **kwargs):
        x, infos = solve(self, b, *args, **kwargs)
        if fault == "state_unchanged":  # the solve returns its initial guess
            x = torch.zeros_like(x)
        elif fault == "half_left_out":  # half the columns, or of a column's unknowns, not done
            x = x.clone()
            if x.ndim == 2 and x.shape[1] > 1:
                x[:, x.shape[1] // 2:] = 0
            else:
                x[x.shape[0] // 2:] = 0
        elif fault == "answer_altered":  # one entry of the answer off by 10 %
            x = x.clone()
            x[7] *= 1.1
        return x, infos

    monkeypatch.setattr(DDMSolver, "solve", broken)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_broken_solve_is_not_correct(tiny_root, cell, fault, monkeypatch):
    root, tiny = tiny_root
    _broken(monkeypatch, fault)
    r = run_tiny(root, tiny[cell], seconds=0.3)
    assert not r["correct"]
    assert r["checks"]["residual"]["value"] > r["checks"]["residual"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_broken_product_is_not_correct(tiny_root, cell, monkeypatch):
    """The operator's product altered where it is produced: one row of H @ x."""
    from htool_tpu_torch.hmatrix.hmatrix import HMatrix

    matmul = HMatrix.__matmul__

    def broken(self, x):
        y = matmul(self, x).clone()
        y[self.perm_t[:50]] *= 1.01
        return y

    monkeypatch.setattr(HMatrix, "__matmul__", broken)
    root, tiny = tiny_root
    r = run_tiny(root, tiny[cell], seconds=0.3)
    assert not r["correct"]
    assert r["checks"]["product_err"]["value"] > r["checks"]["product_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell, cpu):
    """The control (the reference in TF32 in the program's place) fails."""
    import calibrate

    root, tiny = tiny_root
    out = calibrate.reading(Spec(root), tiny[cell], 5, 3, cpu, "tf32")
    assert not out["correct"]
    sound = calibrate.reading(Spec(root), tiny[cell], 5, 3, cpu)
    assert sound["correct"]
    for name in ("residual", "product_err"):
        assert out["checks"][name]["value"] > 30 * sound["checks"][name]["value"]


def test_forbidden_import_after_the_window_fails_the_run(tiny_root, monkeypatch):
    import types

    root, tiny = tiny_root
    monkeypatch.setitem(__import__("sys").modules, "jaxlib", types.ModuleType("jaxlib"))
    with pytest.raises(runner.ForbiddenImport, match="jaxlib"):
        run_tiny(root, tiny["real_solve_stream"], seconds=0.1)
    assert imports.forbidden(["htool_tpu_torch", "htool_tpu_torch.ops.cut", "jax_free",
                              "htool_tpu", "htool_tpu.ops", "flax.linen", "jaxlib"]) == [
        "flax.linen", "htool_tpu", "htool_tpu.ops", "jaxlib"]


def test_a_cell_added_as_files(tiny_root, tmp_path):
    """A new configuration, traffic mix, metric and cell are files and
    entries only: the harness finds them by name and runs the cell."""
    from conftest import add_tiny_cells, copy_benchmark

    root = copy_benchmark(tmp_path)
    add_tiny_cells(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/tiny_sphere_laplace_f32_n100k.json").read_text())
    # another program adapter, and other solver settings passed through as data
    cfg.update(name="throwaway_cfg", n=1100, program="throwaway_program",
               solver=dict(cfg["solver"], schwarz="ras"), solve={"krylov": "gmres", "restart": 30,
                                                                 "tol": 1e-7, "maxiter": 100})
    (root / "benchmark/configs/throwaway_cfg.json").write_text(json.dumps(cfg))
    (root / "benchmark/programs/throwaway_program.py").write_text(
        "from pathlib import Path\nfrom harness.spec import _load_module\n"
        "Base = _load_module(Path(__file__).with_name('ddm_solver.py'), 'p').Program\n\n\n"
        "class Program(Base):\n    builds = 0\n\n    def build(self, points32, spans):\n"
        "        Program.builds += 1\n        return super().build(points32, spans)\n")
    # another traffic kind
    (root / "benchmark/kinds/throwaway_kind.py").write_text(
        "from pathlib import Path\nfrom harness.spec import _load_module\n"
        "Base = _load_module(Path(__file__).with_name('solve_stream.py'), 'k').Loop\n\n\n"
        "class Loop(Base):\n    def unit(self, stream, k):\n"
        "        with self.spans.span('throwaway'):\n"
        "            return super().unit(stream, k)\n")
    mix = json.loads((root / "benchmark/traffic/solve_stream.json").read_text())
    mix.update(kind="throwaway_kind", nrhs=3, check_units=2)
    (root / "benchmark/traffic/throwaway_mix.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/rhs_ms.throwaway.py").write_text(
        "def read(rec):\n    s = rec.span_mean_s('throwaway')\n    return None if s is None else 1e3 * s\n")
    bench["configs"].append(dict(bench["configs"][0], name="throwaway_cfg",
                                 file="benchmark/configs/throwaway_cfg.json"))
    bench["workloads"].append({"name": "throwaway_cell", "config": "throwaway_cfg",
                               "traffic": "throwaway_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("throwaway_cell")
    bench["per_layer"].append({"name": "rhs_ms.throwaway", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "inputs", "moves": "solve_ms",
                               "workloads": ["throwaway_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r0 = run_tiny(root, "throwaway_cell", trace=False, seconds=0.3)
    r1 = run_tiny(root, "throwaway_cell", trace=True, seconds=0.3)
    assert r0["correct"] and r1["correct"]
    assert "solve_ms" in r0["metrics"] and r1["metrics"]["rhs_ms.throwaway"]["value"] > 0
    spec = Spec(root)
    assert spec.program("throwaway_program").builds == 0  # each lookup loads the file anew
    assert spec.kind("throwaway_kind").__mro__[1].kind == "solve_stream"
