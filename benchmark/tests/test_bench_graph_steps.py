"""The reader of ``graph_steps.solve`` on synthetic snapshots of
``htool_tpu_torch.utils.profiling.spans()``: the mean change of the
counter ``krylov_graph_steps`` across the solves, and None where a solve
did not count it (a program without CG's graphs, a run on the CPU), for
the other kind of cell, for an empty recorder and for a program without
the recorder."""

import json

import pytest

from harness.record import Record
from harness.spec import Spec

from conftest import ROOT

CARD = "NVIDIA H100 80GB HBM3"


def root(i, t0, **counters):
    return dict(name="htool.ddm.solve", id=i, parent=None, root=i, t0=t0, t1=t0 + 10,
                counters=dict(syncs=11, launches=207, **counters))


@pytest.fixture
def snapshot(monkeypatch):
    from htool_tpu_torch.utils import profiling

    def set_to(recs):
        monkeypatch.setattr(profiling, "spans", lambda: [dict(x) for x in recs])

    return set_to


def test_mean_steps_a_solve(snapshot):
    read = Spec(ROOT).reader("graph_steps.solve")
    snapshot([root(1, 0, krylov_graph_steps=8), root(2, 100, krylov_graph_steps=9)])
    assert read(Record(kind="solve_stream", device_kind=CARD)) == pytest.approx(8.5)
    assert read(Record(kind="new_problem", device_kind=CARD)) is None
    snapshot([root(1, 0, krylov_graph_steps=8), root(2, 100)])
    assert read(Record(kind="solve_stream", device_kind=CARD)) is None
    snapshot([root(1, 0), root(2, 100)])  # nothing replayed: no graphs, or the CPU
    assert read(Record(kind="solve_stream", device_kind="cpu")) is None
    snapshot([])
    assert read(Record(kind="solve_stream", device_kind=CARD)) is None


def test_without_the_recorder(monkeypatch):
    from htool_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    read = Spec(ROOT).reader("graph_steps.solve")
    assert read(Record(kind="solve_stream", device_kind=CARD)) is None


def test_entry():
    per_layer = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())[
        "per_layer"]}
    assert per_layer["graph_steps.solve"] == dict(
        name="graph_steps.solve", unit="steps", better="higher", source="program_counter",
        layer="Krylov", moves="solve_ms", workloads=["real_solve_stream"])
