"""The readers of the program's own spans and counters, on synthetic
snapshots of ``htool_tpu_torch.utils.profiling.spans()``: each returns the
expected number, and None for the other kind of cell, for an empty recorder
and for a program without the recorder."""

import pytest

from harness.record import Record
from harness.spec import Spec

from conftest import ROOT

STREAM = ["krylov_step_host_us.solve", "syncs.solve", "schwarz_apply_us.solve",
          "product_launches.solve"]
# the same readers in the block-solve cell, which reports ``block_solve_ms``
BLOCK = [name.replace(".solve", ".block") for name in STREAM]
PROBLEM = ["aca_ms.problem", "overlap_ms.problem", "schwarz_local_ms.problem"]


def r(name, i, parent, root, t0, t1, **extra):
    return dict(name=name, id=i, parent=parent, root=root, t0=t0, t1=t1, **extra)


# two solves: ns on the host clock; the second solve's steps have no waits
SOLVES = [
    r("htool.ddm.solve", 1, None, 1, 0, 100_000,
      counters={"syncs": 11, "launches": 153, "plain_calls": 0}),
    r("htool.hmatrix.product", 2, 1, 1, 1_000, 3_000),
    r("htool.schwarz.apply", 3, 1, 1, 3_000, 4_000, device_us=350.0),
    r("htool.krylov.step", 4, 1, 1, 10_000, 30_000),
    r("htool.hmatrix.product", 5, 4, 1, 11_000, 14_000),
    r("htool.schwarz.apply", 6, 4, 1, 15_000, 16_000, device_us=330.0),
    r("htool.krylov.wait", 7, 4, 1, 20_000, 28_000),
    r("htool.ddm.solve", 8, None, 8, 200_000, 300_000,
      counters={"syncs": 12, "launches": 170, "plain_calls": 0}),
    r("htool.krylov.step", 9, 8, 8, 210_000, 216_000),
    r("htool.schwarz.apply", 10, 9, 8, 211_000, 212_000, device_us=340.0),
]
# two problems: one ACA, one overlap and one local build each, and a solve
PROBLEMS = [
    r("htool.assembly.aca", 1, None, 1, 0, 400_000_000, counters={}),
    r("htool.schwarz.overlap", 2, None, 2, 500_000_000, 800_000_000, counters={}),
    r("htool.schwarz.local", 3, None, 3, 800_000_000, 900_000_000, counters={}),
    r("htool.ddm.solve", 4, None, 4, 950_000_000, 970_000_000, counters={"syncs": 11}),
    r("htool.assembly.aca", 5, None, 5, 1_000_000_000, 1_500_000_000, counters={}),
    r("htool.schwarz.overlap", 6, None, 6, 1_600_000_000, 2_000_000_000, counters={}),
    r("htool.schwarz.local", 7, None, 7, 2_000_000_000, 2_050_000_000, counters={}),
]

WANT = {
    # step 4: 20 us less 3 (product), 1 (apply), 8 (wait) = 8; step 9: 6 less 1 = 5
    "krylov_step_host_us.solve": 6.5,
    "syncs.solve": 11.5,
    "schwarz_apply_us.solve": 340.0,
    "product_launches.solve": 161.5,
    "aca_ms.problem": 450.0,
    "overlap_ms.problem": 350.0,
    "schwarz_local_ms.problem": 75.0,
}
WANT.update({b: WANT[s] for s, b in zip(STREAM, BLOCK)})


@pytest.fixture
def snapshot(monkeypatch):
    """Set what the recorder returns."""
    from htool_tpu_torch.utils import profiling

    def set_to(recs):
        monkeypatch.setattr(profiling, "spans", lambda: [dict(x) for x in recs])

    return set_to


def reader(name):
    return Spec(ROOT).reader(name)


@pytest.mark.parametrize("name", STREAM + BLOCK + PROBLEM)
def test_reader_on_a_synthetic_snapshot(name, snapshot):
    kind, other = ("solve_stream", "new_problem") if name not in PROBLEM else (
        "new_problem", "solve_stream")
    snapshot(SOLVES if kind == "solve_stream" else PROBLEMS)
    read = reader(name)
    assert read(Record(kind=kind, device_kind="NVIDIA H100 80GB HBM3")) == pytest.approx(
        WANT[name])
    assert read(Record(kind=other, device_kind="NVIDIA H100 80GB HBM3")) is None
    snapshot([])
    assert read(Record(kind=kind, device_kind="NVIDIA H100 80GB HBM3")) is None


@pytest.mark.parametrize("name", STREAM + BLOCK + PROBLEM)
def test_reader_without_the_recorder(name, monkeypatch):
    """A program whose profiling module has no ``spans`` (the port before
    its recorder): nothing to read, and no exception."""
    from htool_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    kind = "new_problem" if name in PROBLEM else "solve_stream"
    assert reader(name)(Record(kind=kind, device_kind="NVIDIA H100 80GB HBM3")) is None


def test_launches_on_the_cpu_are_plain_calls(snapshot):
    snapshot([r("htool.ddm.solve", 1, None, 1, 0, 10, counters={"launches": 0,
                                                                 "plain_calls": 90})])
    assert reader("product_launches.solve")(Record(kind="solve_stream", device_kind="cpu")) == 90


def test_entries_list_their_cell():
    import json

    per_layer = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())[
        "per_layer"]}
    for names, cells, moves in ((STREAM, ["real_solve_stream"], "solve_ms"),
                                (BLOCK, ["complex_block8_stream"], "block_solve_ms"),
                                (PROBLEM, ["real_new_problem"], "problem_s")):
        for name in names:
            m = per_layer[name]
            assert m["workloads"] == cells and m["moves"] == moves
            assert m["source"] in ("program_span", "program_counter")
