"""The idle-share arithmetic on a synthetic trace, and the roofline's byte
count on a small operator."""

import numpy as np
import pytest
import torch

from harness import devtrace, inputs, roofline
from harness.spec import Spec

from conftest import ROOT


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_summarize_synthetic_trace():
    events = [
        ev("user_annotation", "bench.stretch", 0, 1000),
        ev("user_annotation", "bench.assembly", 0, 600),
        ev("user_annotation", "bench.solve", 600, 400),
        ev("cpu_op", "aten::item", 100, 200),  # the host waits in here
        ev("cpu_op", "aten::_local_scalar_dense", 110, 150),  # nested: not outermost
        ev("cpu_op", "aten::linalg_inv", 700, 50),
        ev("cpu_op", "aten::other_thread", 0, 1000, tid=2),
        # device: two kernels overlap, one memcpy, one kernel past the stretch
        ev("kernel", "k_a", 50, 50), ev("kernel", "k_b", 80, 40),
        ev("gpu_memcpy", "Memcpy DtoH", 400, 100),
        ev("kernel", "k_a", 900, 200),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 10},
    ]
    s = devtrace.summarize(events, wall_s=1e-3)
    # busy: [50, 120) + [400, 500) + [900, 1000) clipped = 70 + 100 + 100 µs
    assert s["busy_s"] == pytest.approx(270e-6)
    assert s["window_s"] == 1e-3 and s["device_events"] == 4
    assert s["device_ops"][0] == ["k_a", pytest.approx(250e-6)]
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    # gaps: [0,50) assembly/python, [120,400) assembly/aten::item (mid 260),
    # [500,900): mid 700 solve/aten::linalg_inv
    assert gaps == {"bench.assembly/python": pytest.approx(50e-6),
                    "bench.assembly/aten::item": pytest.approx(280e-6),
                    "bench.solve/aten::linalg_inv": pytest.approx(400e-6)}
    assert sum(gaps.values()) + s["busy_s"] == pytest.approx(1e-3)


def test_summarize_keeps_ten_largest():
    events = [ev("user_annotation", "bench.stretch", 0, 100)]
    events += [ev("kernel", f"k{i}", i * 5, 1 + i % 3) for i in range(20)]
    s = devtrace.summarize(events, wall_s=1e-4)
    assert len(s["device_ops"]) == 10 and len(s["idle_gaps"]) <= 10
    assert s["device_ops"][0][1] >= s["device_ops"][-1][1]


@pytest.mark.parametrize("symmetry,UPLO,eta", [("N", "N", 10.0), ("S", "L", 100.0)])
def test_product_bytes_on_a_small_operator(symmetry, UPLO, eta):
    """Every stored coefficient once; with symmetric storage, the stored
    triangle's."""
    import htool_tpu_torch as ht

    pts = inputs.sphere_points(1500, 2, 0)
    kernel = Spec(ROOT).kernel("laplace_symmetric")
    P = torch.as_tensor(pts)
    tree = ht.build_cluster_tree(pts.astype(np.float64), max_leaf_size=64)
    H = ht.build_hmatrix(ht.KernelGenerator(kernel, P, P), tree, epsilon=1e-3, eta=eta,
                         symmetry=symmetry, UPLO=UPLO)
    info = ht.hmatrix_info(H)
    generated = 1500 * 1500 / info["compression_ratio"]
    for k in (1, 8):
        want = 4 * (generated + k * 3000)
        assert roofline.product_bytes(H, k) == pytest.approx(want, rel=1e-12)
    # the count is of true sizes, not of the padded bucket storage
    padded = sum(b.data.numel() for b in H.dense_buckets) + sum(
        b.U.numel() + b.V.numel() for b in H.lr_buckets)
    assert roofline.product_bytes(H, 1) < 4 * padded


def test_peaks():
    assert roofline.peak_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.peak_bandwidth("cpu") is None
