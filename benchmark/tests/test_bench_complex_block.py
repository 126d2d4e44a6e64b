"""The cell ``complex_block8_stream`` on the CPU at the tiny size
(``conftest.TINY``): block GMRES on 8 complex right-hand sides is correct,
traced and untraced; a solve broken underneath it, and the control in the
program's place, are not; the readers of block GMRES's spans give the
expected numbers on a synthetic record and None where there is nothing."""

import pytest

from harness.record import Record
from harness.spec import Spec
from test_bench_harness import _broken, run_tiny

from conftest import ROOT

CELL = "complex_block8_stream"
READERS = ["krylov_lstsq_us.solve", "krylov_orth_us.solve"]
# a device metric reads nothing on the CPU, and is left out of the line
DEVICE_ONLY = {"peak_mem_gb", "device_idle.block", "product_roofline.block"}


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run(tiny_root, trace):
    root, tiny = tiny_root
    r = run_tiny(root, tiny[CELL], trace)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["unconverged"]["value"] == 0
    want = {m["name"] for m in Spec(root).metrics(tiny[CELL], trace)}
    assert set(r["metrics"]) == want - DEVICE_ONLY
    for m in r["metrics"].values():
        assert m["value"] > 0
    if trace:
        assert set(READERS) <= set(r["metrics"])
        assert r["metrics"]["iterations.block"]["value"] >= 1


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_broken_solve_is_not_correct(tiny_root, fault, monkeypatch):
    root, tiny = tiny_root
    _broken(monkeypatch, fault)
    r = run_tiny(root, tiny[CELL], seconds=0.3)
    assert not r["correct"]
    assert r["checks"]["residual"]["value"] > r["checks"]["residual"]["limit"]


def test_control_is_not_correct(tiny_root, cpu):
    """The control (the reference in TF32, complex64, in the program's place)
    fails on both numbers, and the program passes, on the same seed."""
    import calibrate

    root, tiny = tiny_root
    out = calibrate.reading(Spec(root), tiny[CELL], 5, 2, cpu, "tf32")
    assert not out["correct"]
    sound = calibrate.reading(Spec(root), tiny[CELL], 5, 2, cpu)
    assert sound["correct"]
    for name in ("residual", "product_err"):
        assert out["checks"][name]["value"] > out["checks"][name]["limit"]


def r(name, i, parent, root, t0, t1, **extra):
    return dict(name=name, id=i, parent=parent, root=root, t0=t0, t1=t1, **extra)


# one solve of two steps; the lstsq after the second step closes the cycle,
# outside any step, and is not read
SOLVE = [
    r("htool.ddm.solve", 1, None, 1, 0, 100_000, counters={"syncs": 4}),
    r("htool.krylov.step", 2, 1, 1, 1_000, 40_000),
    r("htool.krylov.orth", 3, 2, 1, 10_000, 12_000, device_us=900.0),
    r("htool.krylov.lstsq", 4, 2, 1, 12_000, 30_000, device_us=20_000.0),
    r("htool.krylov.step", 5, 1, 1, 40_000, 80_000),
    r("htool.krylov.orth", 6, 5, 1, 50_000, 53_000, device_us=1_100.0),
    r("htool.krylov.lstsq", 7, 5, 1, 53_000, 75_000, device_us=24_000.0),
    r("htool.krylov.lstsq", 8, 1, 1, 81_000, 90_000, device_us=9_000.0),
]
WANT = {"krylov_lstsq_us.solve": 22_000.0, "krylov_orth_us.solve": 1_000.0}


@pytest.mark.parametrize("name", READERS)
def test_reader(name, monkeypatch):
    from htool_tpu_torch.utils import profiling

    read = Spec(ROOT).reader(name)
    stream = Record(kind="solve_stream", device_kind="NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(profiling, "spans", lambda: [dict(x) for x in SOLVE])
    assert read(stream) == pytest.approx(WANT[name])
    assert read(Record(kind="new_problem", device_kind="cpu")) is None
    # a CG solve's record has steps and none of these spans
    monkeypatch.setattr(profiling, "spans", lambda: [dict(x) for x in SOLVE[:2]])
    assert read(stream) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(stream) is None
    monkeypatch.delattr(profiling, "spans")  # a program without the recorder
    assert read(stream) is None
