"""The reader of ``product_read_gb.solve`` on synthetic snapshots of
``htool_tpu_torch.utils.profiling.spans()``: the change of the counter
``product_read_bytes`` over the change of ``products`` across each solve,
in GB, mean over the solves; None where a solve did not count it (a program
without the counter), for the other kind of cell, for an empty recorder and
for a program without the recorder; and the program's counts on the CPU."""

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


def test_mean_gb_a_product(snapshot):
    read = Spec(ROOT).reader("product_read_gb.solve")
    snapshot([root(1, 0, product_read_bytes=9 * 900_000_000, products=9),
              root(2, 100, product_read_bytes=8 * 920_000_000, products=8)])
    assert read(Record(kind="solve_stream", device_kind=CARD)) == pytest.approx(0.91)
    assert read(Record(kind="new_problem", device_kind=CARD)) is None
    snapshot([root(1, 0, product_read_bytes=900_000_000, products=1), root(2, 100, products=8)])
    assert read(Record(kind="solve_stream", device_kind=CARD)) is None
    snapshot([root(1, 0, products=9), root(2, 100, products=8)])  # no planned products
    assert read(Record(kind="solve_stream", device_kind="cpu")) is None
    snapshot([root(1, 0), root(2, 100)])  # a program without the counter
    assert read(Record(kind="solve_stream", device_kind=CARD)) is None
    snapshot([])
    assert read(Record(kind="solve_stream", device_kind=CARD)) is None


def test_without_the_recorder(monkeypatch):
    from htool_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    read = Spec(ROOT).reader("product_read_gb.solve")
    assert read(Record(kind="solve_stream", device_kind=CARD)) is None


def test_the_program_counts_planned_terms_and_products():
    """The counts the reader divides, on a root span: ``products``, and
    ``product_read_bytes``, the plans' own count of what each planned term
    streams (here the plain version's, on the CPU)."""
    import numpy as np
    import torch

    import htool_tpu_torch as ht
    from htool_tpu_torch.hmatrix.linalg import matvec, prepare_tiled_matvec
    from htool_tpu_torch.ops.tiled_matvec import SplitPlan
    from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric
    from htool_tpu_torch.utils import profiling

    pts = torch.as_tensor(create_sphere(600, seed=1))
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    tree = ht.build_cluster_tree(pts.numpy(), max_leaf_size=40)
    H = prepare_tiled_matvec(ht.build_hmatrix(gen, tree, epsilon=1e-3, eta=2.0,
                                              symmetry="S", UPLO="L"))
    x = torch.as_tensor(np.random.RandomState(0).randn(600, 1))
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("htool.ddm.solve"):
            matvec(H, x)
            matvec(H, x)
    (rec,) = [r for r in profiling.spans() if r["name"] == "htool.ddm.solve"]
    assert rec["counters"]["products"] == 2
    # a mirror bucket with a pair plan streams both its terms in one pass and
    # keeps no per-term plans
    per_product = sum(p.streamed_bytes() for b in H.dense_buckets + H.lr_buckets
                      for plan in (b.plan_t, b.plan_s)[: 1 + b.mirror] if plan is not None
                      for p in (plan if isinstance(plan, SplitPlan) else [plan]))
    per_product += sum(b.pair.streamed_bytes() for b in H.dense_buckets + H.lr_buckets
                       if b.pair is not None)
    assert any(b.pair is not None for b in H.dense_buckets + H.lr_buckets)
    assert rec["counters"]["product_read_bytes"] == 2 * per_product > 0
    profiling.clear()


def test_entry():
    per_layer = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())[
        "per_layer"]}
    assert per_layer["product_read_gb.solve"] == dict(
        name="product_read_gb.solve", unit="GB", better="lower", source="program_counter",
        layer="product and kernels", moves="solve_ms", workloads=["real_solve_stream"])
    assert per_layer["product_read_gb.block"] == dict(
        per_layer["product_read_gb.solve"], name="product_read_gb.block", moves="block_solve_ms",
        workloads=["complex_block8_stream"])
