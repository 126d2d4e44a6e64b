#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py            # n = 100,000, the flagship size
    python3 chip_smoke.py --n 20000  # a shorter check

Phases (each prints one JSON line):

1. device — the card, and ``nvidia-smi``'s name and power limit line;
2. build — the CUDA kernels are compiled from ``htool_tpu_torch/csrc`` for
   float32, float64, complex64 and complex128 (no one-launch dense entry
   point may be left in the library); then the device rule: an
   H-matrix built from NumPy points with no ``device`` must lie on the card
   (n = 2,000; with plans attached its low-rank buckets, too short for two
   stages, run the one-launch planned kernel, held against the unplanned
   product);
3. main path — sphere → cluster tree → H-matrix (f32, Laplace kernel, leaf
   256, ε = 1e-3, η = 10) → tiled plans → one-level RAS (64 subdomains,
   overlap 0.02, dense local solves) → restarted GMRES(60) to 1e-6, twice,
   then once more with a float64 NumPy right-hand side (GMRES in float64,
   every product still through the kernel); the matvec at k = 8 is timed
   with the kernel and with its plain version, and checked against
   generator rows; assembly and the Schwarz set-up are timed again warm;
4. kernel vs plain — every bucket term of that H-matrix, both
   orientations, k = 1 and 8, f32 and f64, against the plain PyTorch
   version on the same CUDA tensors; every low-rank bucket through its
   one-launch plan and through its split two-stage plan, both timed;
5. kernel edges — the same comparison on random buckets with shapes the
   flagship does not reach: ranks above 64, non-square and 6272-wide
   blocks, odd widths with rank 99 (no 16-byte alignment: the element-wise
   copy path), rank 1, a bucket of one 6272 x 6272 block, k = 1, 2, 3, 5, 8
   and 11;
6. profile — ``torch.profiler`` windows over the
   warm solve, 20 products at k = 1 and at k = 8, a warm assembly and a warm
   Schwarz set-up.  Device busy time is the union of the kernel, memcpy and
   memset intervals of the trace; the idle share is 1 - busy / the window's
   host wall time, which the profiler itself lengthens;
7. unplanned path — the same points, a tree of 8 partitions, a symmetric
   (``"S"``, ``"L"``) H-matrix with no tiled plans, ``H @ x`` for op N and T
   at k = 1 and 8 through the unplanned CUDA kernels, then the 8 partition
   block rows that the distributed operator gives its devices (N on the
   global x, stacked; T on each local slice, summed), all checked against
   generator rows; products timed with the kernels and with their plain
   versions;
8. unplanned kernels vs plain — every bucket term of that H-matrix and of
   one block row, both orientations, k = 1 and 8, f32 and f64 (every dense
   term through the streaming dense kernel, float64 on the FP64 tensor
   cores at k = 8; every low-rank term through the one-launch and the
   two-stage kernel), and the random buckets of phase 5's edge shapes with
   root offsets (dense blocks cut into panels and slabs: 224² and 256²;
   odd widths without 16-byte alignment; k = 1, 2, 3, 5, 8, 11);
9. compressors — full ACA, SVD and partial ACA with SVD recompression at
   ``--compress-n`` points (10,000), each checked against generator rows;
10. profile — 20 unplanned products at k = 8;
11. complex main path — the same points and 64-partition tree, a complex64
    H-matrix (``laplace_kernel_complex_symmetric``, symmetry "N") → complex
    tiled plans → ``matvec`` for N, T and C at k = 8 against generator rows
    and columns → one-level RAS → ``block_gmres`` (three times: its count
    must not move with the kernels' atomics) and ``gmres`` on 8 complex
    right-hand sides to 1e-6, ``gmres`` on the real flagship's x, and one
    complex128 product; every
    term through the complex tiled kernel (launches = terms × products, no
    plain version called); products timed at k = 1 and 8, kernel and plain;
12. hermitian unplanned path — ``symmetry="H"``, ``UPLO="L"`` on the
    8-partition tree, no plans: ``H @ x`` and ops T and C at k = 1 and 8
    through the unplanned kernels in their complex form (the mirror terms
    need Bᴴ and conj(B)), against generator rows and columns;
13. complex kernels vs plain — every bucket term of both complex
    H-matrices, all four of B, Bᵀ, conj(B), Bᴴ, k = 1 and 8, complex64 and
    complex128 (complex128 at k = 8 on the FP64 tensor cores), the edge
    shapes of phases 5 and 8, and a real H-matrix on a complex x (the real
    kernels on x viewed as 2k real columns);
14. profile — 20 complex products at k = 8;
15. per-call floor — what one wrapper call on a bucket of one tiny block
    costs, on the host clock over 1,000 calls and between CUDA events.

The ``kernels`` line before the last lists every entry point (three kernels
× float32, float64, complex64, complex128, and the planned kernel's split
two-stage low-rank terms apart) with its launches on the main paths (also
split by k), its time summed over the main path's terms at k = 8 (and,
under ``k1``, at k = 1) beside the plain version's, its bound (bytes moved
once over 3.35 TB/s, a split term's staging tensor written and read once
included, or operations over the peak rate of the type, whichever is
larger) and, as the library yardstick, ``torch.bmm`` on windows gathered
beforehand (gather and scatter excluded: no single PyTorch call computes a
bucket term).

Any failed check raises, so the script exits non-zero.  Only when every
phase passes does the last line read
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np


_phase_log = None  # with --out: every emitted line is also appended to this file


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _phase_log:
        with open(_phase_log, "a") as f:
            f.write(line + "\n")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def profile_window(name, fn) -> dict:
    """Run fn under torch.profiler; device busy time is the union of the
    trace's kernel, memcpy and memset intervals, over the window's host
    wall time."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in dev:
        ms, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    busy = busy_us / 1e6
    require(len(dev) > 0, f"profile window {name}: no device events in the trace")
    return dict(window=name, wall_s=wall, device_busy_s=busy, idle_share=1 - busy / wall,
                n_device_events=len(dev),
                top_ms=[[n[:72], ms, count] for n, (ms, count) in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000, help="number of points")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress-n", type=int, default=10_000,
                    help="number of points of the compressors phase")
    ap.add_argument("--out", default=None,
                    help="directory for the per-bucket timing tables and a copy of every "
                         "phase line (chip_smoke_phases.jsonl)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    if args.out:
        global _phase_log
        os.makedirs(args.out, exist_ok=True)
        _phase_log = os.path.join(args.out, "chip_smoke_phases.jsonl")
        open(_phase_log, "w").close()

    import htool_tpu_torch as ht
    import htool_tpu_torch.ops.bucket_matvec as bucket_ops
    import htool_tpu_torch.ops.tiled_matvec as tiled_ops
    from htool_tpu_torch.hmatrix import linalg
    from htool_tpu_torch.hmatrix.linalg import matvec, matvec_user, prepare_tiled_matvec
    from htool_tpu_torch.kernels import SUFFIX_OF, build_info, load_library
    from htool_tpu_torch.ops.bucket_matvec import (
        dense_bucket_matvec,
        dense_bucket_matvec_reference,
        lr_bucket_matvec,
        lr_bucket_matvec_reference,
    )
    from htool_tpu_torch.ops.cut import lr_split_wanted
    from htool_tpu_torch.ops.tiled_matvec import (
        SplitPlan,
        build_tile_plan,
        build_tile_plan_lr_split,
        tiled_bucket_matvec,
        tiled_bucket_matvec_reference,
    )
    from htool_tpu_torch.solvers import DDMSolver
    from htool_tpu_torch.testing import (
        create_sphere,
        laplace_kernel_complex_symmetric,
        laplace_kernel_hermitian,
        laplace_kernel_symmetric,
    )

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    wrappers = (tiled_bucket_matvec, dense_bucket_matvec, lr_bucket_matvec)
    DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)

    # launches of each entry point on the main paths: every count is set to 0
    # just before a main path is driven and read just after
    path_launches: dict = {}

    path_launches_k: dict = {}  # the same, split by the k of the launch
    path_cuda_launches: dict = {}  # CUDA launches behind them (two for a two-stage term)
    SPLIT = "tiled_bucket_matvec_split"  # row 1c: the planned kernel's split terms apart

    def reset_counts():
        for w in wrappers:
            w.launches = 0
            w.cuda_launches = 0
            w.launches_by_dtype.clear()
            w.launches_by_k.clear()
        matvec.products = 0

    def collect_split(n_split, n_terms):
        """The split terms among the planned terms launched since the counts
        were set to 0: each product launched its n_terms terms once, n_split
        of them through split plans (two CUDA launches each)."""
        total = 0
        for (dt, k), c in tiled_bucket_matvec.launches_by_k.items():
            require(c % n_terms == 0, f"planned launches {c} at {dt} k={k}: not whole products")
            c_split = c // n_terms * n_split
            total += c_split
            path_launches[(SPLIT, dt)] = path_launches.get((SPLIT, dt), 0) + c_split
            by_k = path_launches_k.setdefault((SPLIT, dt), {})
            by_k[k] = by_k.get(k, 0) + c_split
        require(tiled_bucket_matvec.cuda_launches - tiled_bucket_matvec.launches == total,
                f"split terms {total} != extra CUDA launches")

    def collect_launches():
        for w in wrappers:
            for dt, c in w.launches_by_dtype.items():
                path_launches[(w.__name__, dt)] = path_launches.get((w.__name__, dt), 0) + c
            for (dt, k), c in w.launches_by_k.items():
                by_k = path_launches_k.setdefault((w.__name__, dt), {})
                by_k[k] = by_k.get(k, 0) + c
            path_cuda_launches[w.__name__] = (path_cuda_launches.get(w.__name__, 0)
                                              + w.cuda_launches)

    # per entry point, over the main path's terms at k = 8: time of the kernel,
    # of its plain version and of torch.bmm on windows gathered beforehand,
    # the bytes each launch must move (blocks, x and y once) and its
    # operations (2 per real multiply-add, 8 per complex one)
    PEAK_BYTES_S = 3.35e12  # H100 SXM, HBM3
    # non-tensor-core rates (H100 SXM data sheet): 67 TFLOP/s float32, half
    # of it float64; the complex types run on the same units
    PEAK_FLOPS_S = {torch.float32: 67e12, torch.complex64: 67e12,
                    torch.float64: 33.5e12, torch.complex128: 33.5e12}
    stats: dict = {}
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def stat(name, dtype):
        return stats.setdefault((name, dtype), dict(
            ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0, max_abs_err=0.0, terms=0,
            k1=dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0, terms=0)))

    def event_ms(fn, reps=3):
        fn()
        ev0.record()
        for _ in range(reps):
            fn()
        ev1.record()
        sync()
        return ev0.elapsed_time(ev1) / reps

    def account(name, blocks, x, y_rows, in_off, in_w, trans, conj, ms, plain_ms, t_rows=0):
        """Add one main-path term at k = 8 or k = 1 to the sums of entry
        point ``name``; ``t_rows``: rows of a split term's staging tensor
        (written and read once)."""
        st = stat(name, x.dtype)
        k, item = x.shape[1], x.element_size()
        if k == 1:
            st = st["k1"]
        st["terms"] += 1
        st["ms"] += ms
        st["plain_ms"] += plain_ms
        st["bytes"] += item * (sum(b.numel() for b in blocks) + x.numel() + y_rows * k
                               + 2 * t_rows * k)
        st["flops"] += (8 if x.dtype.is_complex else 2) * k * sum(b.numel() for b in blocks)
        # the library yardstick: bmm on the gathered windows
        xg = x[in_off.long()[:, None] + torch.arange(in_w, device=x.device)]
        ops = [b.conj() if conj else b for b in blocks]
        ops = [b.transpose(1, 2) for b in reversed(ops)] if trans else ops

        def bmm():
            t = xg
            for b in reversed(ops):
                t = torch.bmm(b, t)

        st["library_ms"] += event_ms(bmm)

    # ---------------- 1. device ----------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
              torch=torch.__version__, cuda=torch.version.cuda))

    # ---------------- 2. build ----------------
    lib = load_library()
    emit(dict(phase="build", seconds=build_info["seconds"], library=build_info["library"],
              ptxas=[l.strip() for l in build_info["ptxas"].splitlines()
                     if "registers" in l or "spill" in l]))
    left = [f"htool_dense_bucket_matvec{sfx}" for sfx in SUFFIX_OF.values()
            if hasattr(lib, f"htool_dense_bucket_matvec{sfx}")]
    require(not left, f"one-launch dense entry points still exported: {left}")

    # ---------------- 2b. the device rule ----------------
    # NumPy points and no ``device``: the quick start must land on the card
    pts0 = create_sphere(2000, seed=args.seed)
    gen0 = ht.KernelGenerator(laplace_kernel_symmetric, pts0, pts0)
    H0 = ht.build_hmatrix(gen0, ht.build_cluster_tree(pts0, max_leaf_size=64), epsilon=1e-3,
                          eta=10.0)
    reset_counts()
    y0 = H0 @ np.random.RandomState(args.seed).randn(2000)
    A0 = gen0.block(torch.arange(2000, device=dev), torch.arange(2000, device=dev)).double()
    x0 = torch.as_tensor(np.random.RandomState(args.seed).randn(2000), device=dev)
    err0 = float(torch.linalg.norm(y0 - A0 @ x0) / torch.linalg.norm(A0 @ x0))
    launched0 = dense_bucket_matvec.launches + lr_bucket_matvec.launches
    emit(dict(phase="device_default", generator_device=str(gen0.device),
              hmatrix_device=str(H0.device), product_device=str(y0.device),
              kernel_launches=launched0, rel_error=err0))
    require(gen0.device.type == "cuda" and H0.device.type == "cuda" and y0.device.type == "cuda"
            and all(b.data.is_cuda for b in H0.dense_buckets)
            and all(b.U.is_cuda and b.V.is_cuda for b in H0.lr_buckets),
            "NumPy input with no device did not land on the GPU")
    require(launched0 > 0 and err0 < 1e-3, f"device rule: launches {launched0}, rel {err0:.3e}")
    # the same small operator with plans: its low-rank buckets are too short
    # for a second launch to pay (ops/cut.py::lr_split_wanted), so this is the
    # user's path through the one-launch planned kernel
    x0k = torch.as_tensor(np.random.RandomState(args.seed + 1).randn(2000, 8), device=dev)
    y0u = matvec(H0, x0k)
    prepare_tiled_matvec(H0)
    n_one0 = sum(not isinstance(b.plan_t, SplitPlan) for b in H0.lr_buckets)
    n_terms0 = len(H0.dense_buckets) + len(H0.lr_buckets)
    reset_counts()
    y0p = matvec(H0, x0k)
    torch.cuda.synchronize()
    rel0 = float(torch.linalg.norm(y0p - y0u) / torch.linalg.norm(y0u))
    emit(dict(phase="small_planned_path", n=2000, dtype=str(H0.dtype), bucket_terms=n_terms0,
              one_launch_plans=n_one0, launches=tiled_bucket_matvec.launches,
              cuda_launches=tiled_bucket_matvec.cuda_launches, planned_vs_unplanned_rel=rel0))
    require(n_one0 > 0 and tiled_bucket_matvec.launches == n_terms0
            and tiled_bucket_matvec.cuda_launches == n_terms0 + len(H0.lr_buckets) - n_one0,
            f"small planned path: {n_one0} one-launch plans, {tiled_bucket_matvec.launches} terms "
            f"launched of {n_terms0}, {tiled_bucket_matvec.cuda_launches} CUDA launches")
    require(rel0 <= 1e-12 if H0.dtype == torch.float64 else rel0 <= 1e-5,
            f"small planned path: planned against unplanned rel {rel0:.3e}")
    del H0, gen0, A0, y0, x0, x0k, y0u, y0p

    # ---------------- 3. main path ----------------
    n, P, eps, tol = args.n, 64, 1e-3, 1e-6
    rng = np.random.RandomState(args.seed)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    pts = create_sphere(n, seed=args.seed)
    pts_d = torch.as_tensor(pts.astype(np.float32), device=dev)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts_d, pts_d)
    t0 = time.perf_counter()
    tree = ht.build_cluster_tree(pts, max_leaf_size=256, n_partitions=P)
    t_tree = time.perf_counter() - t0
    t0 = time.perf_counter()
    H = ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0)
    sync()
    t_asm = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepare_tiled_matvec(H)
    sync()
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = DDMSolver(H, gen, tree, schwarz="ras", overlap_radius=0.02, local_solver="dense")
    t_facto = time.perf_counter() - t0

    x_true = torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
    b = H @ x_true
    solves = []
    for _ in range(2):  # cold, warm
        t0 = time.perf_counter()
        x, infos = solver.solve(b, tol=tol, krylov="gmres", restart=60, maxiter=200)
        solves.append(time.perf_counter() - t0)
    residual = float(torch.linalg.norm(H @ x - b) / torch.linalg.norm(b))

    xk = torch.as_tensor(rng.randn(n, 8).astype(np.float32), device=dev)
    y = matvec(H, xk)
    sync()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        y = matvec(H, xk)
    sync()
    t_mv = (time.perf_counter() - t0) / iters

    # error oracle in USER numbering on 256 sampled rows
    yu = matvec_user(H, xk).double()
    sub = rng.choice(n, 256, replace=False)
    A_rows = gen.block(torch.as_tensor(sub, device=dev), torch.arange(n, device=dev)).double()
    y_ref = A_rows @ xk.double()
    mv_rel = float(torch.linalg.norm(yu[sub] - y_ref) / torch.linalg.norm(y_ref))
    sync()

    launches = tiled_bucket_matvec.launches
    cuda_launches = tiled_bucket_matvec.cuda_launches
    products = matvec.products
    require(dense_bucket_matvec.launches == lr_bucket_matvec.launches == 0,
            "a planned product launched an unplanned kernel")
    buckets = H.dense_buckets + H.lr_buckets
    require(H.symmetry == "N", "the flagship H-matrix is non-symmetric: one term per bucket")
    terms = len(buckets)
    info = ht.hmatrix_info(H)
    peak = torch.cuda.max_memory_allocated()

    # a float64 right-hand side from NumPy, as a user may pass one: GMRES then
    # works in float64 and each product runs the kernel on float64 copies of
    # the float32 blocks
    l0, p0 = tiled_bucket_matvec.launches, matvec.products
    t0 = time.perf_counter()
    x64, infos64 = solver.solve(b.double().cpu().numpy(), tol=tol, krylov="gmres",
                                restart=60, maxiter=200)
    t_solve64 = time.perf_counter() - t0
    launches64 = tiled_bucket_matvec.launches - l0
    products64 = matvec.products - p0
    residual64 = float(torch.linalg.norm(H @ x64 - b.double()) / torch.linalg.norm(b.double()))
    collect_split(sum(isinstance(b.plan_t, SplitPlan) for b in H.lr_buckets),
                  len(H.dense_buckets) + len(H.lr_buckets))
    collect_launches()

    # the same k = 8 product through the plain version of the kernel
    linalg.tiled_bucket_matvec = tiled_bucket_matvec_reference
    try:
        y_plain = matvec(H, xk)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            y_plain = matvec(H, xk)
        sync()
        t_mv_plain = (time.perf_counter() - t0) / iters
    finally:
        linalg.tiled_bucket_matvec = tiled_bucket_matvec
    mv_vs_plain = float(torch.linalg.norm(y - y_plain) / torch.linalg.norm(y_plain))
    del y_plain

    # warm set-up: the first assembly and Schwarz build in a process also
    # pay CUDA's one-time library and kernel loading
    t0 = time.perf_counter()
    H_warm = ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0)
    sync()
    t_asm_warm = time.perf_counter() - t0
    del H_warm
    t0 = time.perf_counter()
    DDMSolver(H, gen, tree, schwarz="ras", overlap_radius=0.02, local_solver="dense")
    t_facto_warm = time.perf_counter() - t0

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_iterations.json")) as f:
        ref_iters = json.load(f)["ras_gmres_1level"]
    emit(dict(
        phase="main_path", n=n, subdomains=P, epsilon=eps, tol=tol,
        tree_s=t_tree, assembly_s=t_asm, aca_s=H.info["aca_walltime"],
        assembly_warm_s=t_asm_warm, prepare_s=t_prep, facto_s=t_facto,
        facto_warm_s=t_facto_warm, solve_cold_s=solves[0], solve_warm_s=solves[1],
        compression_ratio=info["compression_ratio"], n_false_positive=info["n_false_positive"],
        rank_mean=info["rank_mean"], rank_max=info["rank_max"],
        n_dense_buckets=len(H.dense_buckets), n_lr_buckets=len(H.lr_buckets),
        local_size_max=infos["Local_size_max"], gmres_iterations=infos["Nb_it"],
        reference_iterations=ref_iters, residual=residual,
        f64_rhs_solve_s=t_solve64, f64_rhs_iterations=infos64["Nb_it"],
        f64_rhs_residual=residual64,
        f64_rhs_launches=launches64, f64_rhs_products=products64,
        matvec_k8_s=t_mv, matvec_k8_plain_s=t_mv_plain, matvec_kernel_vs_plain_rel=mv_vs_plain,
        matvec_rel_error=mv_rel, max_memory_allocated_bytes=peak,
        launches=launches, products=products, bucket_terms=terms,
        cuda_launches=cuda_launches,
        split_plans=sum(isinstance(b.plan_t, SplitPlan) for b in H.lr_buckets),
    ))
    n_split = sum(isinstance(b.plan_t, SplitPlan) for b in H.lr_buckets)
    require(all(isinstance(b.plan_t, SplitPlan) == lr_split_wanted(
                b.n_blocks, *b.block_shape, b.rank_padded, b.U.element_size())
                for b in H.lr_buckets),
            "prepare_tiled_matvec: a low-rank bucket's plan is not the rule's")
    require(cuda_launches == (terms + n_split) * products,
            f"CUDA launches {cuda_launches} != (terms {terms} + split plans {n_split}) x "
            f"products {products}")
    require(all(bool(torch.isfinite(t).all()) for t in (x, y, yu)), "non-finite output")
    require(tuple(x.shape) == (n,) and tuple(y.shape) == (n, 8), "output shapes")
    require(mv_rel < eps, f"matvec rel error {mv_rel:.3e} >= eps {eps}")
    require(residual < 10 * tol, f"GMRES true residual {residual:.3e} >= 10*tol")
    require(x64.dtype == torch.float64 and bool(torch.isfinite(x64).all()), "float64 solve output")
    require(residual64 < 10 * tol, f"float64-rhs GMRES true residual {residual64:.3e} >= 10*tol")
    require(products64 > 0 and launches64 == terms * products64,
            f"float64 rhs: kernel launches {launches64} != bucket terms {terms} "
            f"x products {products64}")
    require(mv_vs_plain < 1e-5, f"matvec kernel vs plain {mv_vs_plain:.3e}")
    require(launches > 0 and launches == terms * products,
            f"kernel launches {launches} != bucket terms {terms} x products {products}")

    # ---------------- 4. kernel vs plain, per bucket term ----------------
    tol_rel = {torch.float32: 1e-5, torch.float64: 1e-12,
               torch.complex64: 1e-5, torch.complex128: 1e-12}
    m_pad = H.shape[0] + linalg._pad_in_of(H)
    rows, worst = [], {}

    def compare(plan, xp, what, conj=False, main=True, ref_plan=None):
        """Kernel vs plain version on the same CUDA tensors (the plain
        version of ``ref_plan`` when given: a split plan is also held against
        the one-launch plan's plain version): the relative error; a
        main-path term's largest absolute error goes to its entry point's
        row."""
        yk = tiled_bucket_matvec(plan, xp, conj=conj)
        yr = tiled_bucket_matvec_reference(ref_plan or plan, xp, conj=conj)
        sync()
        require(bool(torch.isfinite(yk).all()), f"non-finite kernel output {what}")
        rel = float(torch.linalg.norm(yk - yr) / torch.linalg.norm(yr).clamp_min(1e-300))
        require(rel <= tol_rel[xp.dtype], f"{what}: rel {rel:.3e}")
        if main:
            err = float((yk - yr).abs().max())
            for nm in ("tiled_bucket_matvec", SPLIT) if isinstance(plan, SplitPlan) else (
                    "tiled_bucket_matvec",):
                st = stat(nm, xp.dtype)
                st["max_abs_err"] = max(st["max_abs_err"], err)
        return rel

    def routes_of(bucket, side, out_len):
        """Every plan a bucket term can run through: one route for a dense
        bucket, the one-launch and the split plan for a low-rank one; and
        the name of the route prepare_tiled_matvec picks."""
        if isinstance(bucket, ht.DenseBucket):
            return {"dense": build_tile_plan(bucket, side, out_len)}, "dense"
        picked = "split" if lr_split_wanted(bucket.n_blocks, *bucket.block_shape,
                                            bucket.rank_padded,
                                            bucket.U.element_size()) else "one_launch"
        return {"one_launch": build_tile_plan(bucket, side, out_len),
                "split": build_tile_plan_lr_split(bucket, side, out_len)}, picked

    def time_tiled(routes, picked, bucket, side, xp, conj=False):
        """ms of every route of one planned term and of the plain version;
        the picked route's time goes to its entry point's sums (k = 8 and
        k = 1)."""
        ms = {name: event_ms(lambda pl=pl: tiled_bucket_matvec(pl, xp, conj=conj))
              for name, pl in routes.items()}
        first = next(iter(routes.values()))
        tp = event_ms(lambda: tiled_bucket_matvec_reference(first, xp, conj=conj))
        if xp.shape[1] in (1, 8):
            is_dense = isinstance(bucket, ht.DenseBucket)
            blocks = [bucket.data] if is_dense else [bucket.U, bucket.V]
            bm, bn = bucket.block_shape
            term = (blocks, xp, first.out_len, bucket.s_off if side == "t" else bucket.t_off,
                    bn if side == "t" else bm, side == "s", conj, ms[picked], tp)
            account("tiled_bucket_matvec", *term)
            if picked == "split":  # row 1c: the split terms apart, staging tensor included
                account(SPLIT, *term, t_rows=routes["split"].stage_a.out_len)
        return ms, tp

    total = {(k, "kernel"): 0.0 for k in (1, 8)} | {(k, "plain"): 0.0 for k in (1, 8)}
    for bi, bucket in enumerate(buckets):
        is_dense = isinstance(bucket, ht.DenseBucket)
        for dtype in (torch.float32, torch.float64):
            bk = bucket
            if dtype == torch.float64:
                bk = (dataclasses.replace(bucket, data=bucket.data.double()) if is_dense else
                      dataclasses.replace(bucket, U=bucket.U.double(), V=bucket.V.double()))
            for side in ("t", "s"):
                routes, picked = routes_of(bk, side, m_pad)
                if dtype == torch.float32:  # the main path's own plan for the picked route
                    routes[picked] = getattr(bucket, f"plan_{side}")
                ref_plan = next(iter(routes.values()))
                for k in (1, 8):
                    xp = torch.randn((m_pad, k), dtype=dtype, device=dev)
                    for route, plan in routes.items():
                        key = (str(dtype), side, k, route)
                        rel = compare(plan, xp, f"bucket {bi} {key}", ref_plan=ref_plan,
                                      main=route == picked)
                        worst[key] = max(worst.get(key, 0.0), rel)
                    if side == "t":  # the main path's orientation
                        ms, tp = time_tiled(routes, picked, bk, side, xp)
                        if dtype == torch.float32:
                            total[(k, "kernel")] += ms[picked]
                            total[(k, "plain")] += tp
                        rows.append(dict(
                            bucket=bi, kind="dense" if is_dense else "lr", dtype=str(dtype),
                            n_blocks=bucket.n_blocks, block_shape=bucket.block_shape,
                            rank=None if is_dense else bucket.rank_padded, k=k,
                            route=picked, route_ms=ms, kernel_ms=ms[picked], plain_ms=tp,
                        ))
            del bk, routes
    max_abs_err = stats[("tiled_bucket_matvec", torch.float32)]["max_abs_err"]
    emit(dict(phase="kernel_vs_plain", tolerance_rel=dict(float32=1e-5, float64=1e-12),
              worst_rel={"/".join(map(str, k)): v for k, v in sorted(worst.items())},
              max_abs_err_f32=max_abs_err,
              all_terms_k1_ms=total[(1, "kernel")], all_terms_k1_plain_ms=total[(1, "plain")],
              all_terms_k8_ms=total[(8, "kernel")], all_terms_k8_plain_ms=total[(8, "plain")],
              all_terms_k8_f64_ms=stats[("tiled_bucket_matvec", torch.float64)]["ms"]))
    if args.out:
        with open(os.path.join(args.out, "chip_smoke_buckets.json"), "w") as f:
            json.dump(dict(nvidia_smi=smi, n=n, rows=rows), f, indent=1)

    # ---------------- 5. kernel vs plain past the main path's shapes ----------------
    # ranks above one shared-memory pass of the kernel (64 rows), non-square
    # and wide blocks (low-rank storage classes reach thousands of columns at
    # larger n), and k other than 1 and 8 (partial column chunks, scalar loads)
    gen_r = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape, dtype):
        return torch.randn(shape, dtype=dtype, device=dev, generator=gen_r)

    L = 20_000
    # (kind, (bm, bn, r, nb)): wide and non-square blocks, a rank above 64, odd
    # widths (37 x 101; rank 99: float32 rows of 396 bytes, no 16-byte
    # alignment, the element-wise copy path), rank 1, a bucket of one 6272 x
    # 6272 block, and few 224² and 256² dense blocks that the cut splits into
    # panels and slabs (P > 1)
    EDGE_SHAPES = (("dense", (416, 1568, 0, 96)), ("dense", (37, 101, 0, 11)),
                   ("dense", (224, 224, 0, 3)), ("dense", (256, 256, 0, 4)),
                   ("lr", (6272, 2080, 96, 48)), ("lr", (1001, 777, 99, 6)),
                   ("lr", (333, 517, 1, 9)), ("lr", (6272, 6272, 8, 1)))
    EDGE_KS = (1, 2, 3, 5, 8, 11)
    edge_shapes = [dict(kind=kd, bm=a, bn=b, rank=r, n_blocks=nb)
                   for kd, (a, b, r, nb) in EDGE_SHAPES]

    def tiled_edges(dtypes, conjs=(False,)):
        worst_of = {}
        for bkind, (bm, bn, r, nb) in EDGE_SHAPES:
            for dtype in dtypes:
                offs = dict(t_off=torch.randint(0, L - bm, (nb,), device=dev, generator=gen_r),
                            s_off=torch.randint(0, L - bn, (nb,), device=dev, generator=gen_r))
                bucket = (ht.DenseBucket(data=randn(nb, bm, bn, dtype=dtype), **offs)
                          if bkind == "dense"
                          else ht.LowRankBucket(U=randn(nb, bm, r, dtype=dtype),
                                                V=randn(nb, r, bn, dtype=dtype), **offs))
                for side in ("t", "s"):
                    routes, _ = routes_of(bucket, side, L)
                    ref_plan = next(iter(routes.values()))
                    for conj in conjs:
                        for k in EDGE_KS:
                            xp = randn(L, k, dtype=dtype)
                            for route, plan in routes.items():
                                key = f"{dtype}/{side}/conj{int(conj)}/{route}/{bm}x{bn}r{r}"
                                worst_of[key] = max(worst_of.get(key, 0.0), compare(
                                    plan, xp, f"{key} k={k}", conj=conj, main=False,
                                    ref_plan=ref_plan))
                del bucket, routes
        return worst_of

    emit(dict(phase="kernel_edges", shapes=edge_shapes, ks=EDGE_KS,
              worst_rel=tiled_edges((torch.float32, torch.float64))))

    # ---------------- 6. profile ----------------
    x1 = xk[:, :1].contiguous()

    def products(xr):
        for _ in range(iters):
            matvec(H, xr)

    windows = (
        ("gmres_solve_warm", lambda: solver.solve(b, tol=tol, krylov="gmres",
                                                  restart=60, maxiter=200)),
        ("matvec_k1_x20", lambda: products(x1)),
        ("matvec_k8_x20", lambda: products(xk)),
        ("assembly_warm", lambda: ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0)),
        ("schwarz_setup_warm", lambda: DDMSolver(H, gen, tree, schwarz="ras",
                                                 overlap_radius=0.02, local_solver="dense")),
    )
    for name, fn in windows:
        emit(dict(phase="profile", **profile_window(name, fn)))

    # ---------------- 7. unplanned path: symmetric H-matrix and its block rows ----------------
    del H, solver, windows, buckets
    torch.cuda.empty_cache()
    P8 = 8
    tree8 = ht.build_cluster_tree(pts, max_leaf_size=256, n_partitions=P8)
    perm8 = torch.as_tensor(tree8.permutation, device=dev)
    t0 = time.perf_counter()
    HS = ht.build_hmatrix(gen, tree8, epsilon=eps, eta=10.0, symmetry="S", UPLO="L")
    sync()
    t_asm_sym = time.perf_counter() - t0
    t0 = time.perf_counter()
    block_rows = [ht.HMatrixBuilder(epsilon=eps, eta=10.0, symmetry="S", UPLO="L",
                                    partition_number_for_symmetry=p).build(gen, tree8, target_partition=p)
                  for p in range(P8)]
    sync()
    t_rows = time.perf_counter() - t0

    def n_terms(h):
        return sum(1 + bool(b.mirror) for b in h.dense_buckets + h.lr_buckets)

    def rel_rows(y_user, xr):
        """Relative error of y on the 256 sampled rows of A x."""
        ref = A_rows @ xr.double()
        return float(torch.linalg.norm(y_user[sub].double() - ref) / torch.linalg.norm(ref))

    unplanned = [HS, *block_rows]
    require(all(b.plan_t is None and b.plan_s is None
                for h in unplanned for b in h.dense_buckets + h.lr_buckets), "no tiled plans")
    require(any(b.mirror for b in HS.dense_buckets + HS.lr_buckets), "mirror buckets in H")
    require(sum(h.shape[0] for h in block_rows) == n and block_rows[-1].t_root_off > 0,
            "block rows cover the rows")
    xs = {k: torch.as_tensor(rng.randn(n, k).astype(np.float32), device=dev) for k in (1, 8)}

    reset_counts()
    expected, sym_err, row_err = 0, {}, {}
    for op in ("N", "T"):
        for k in (1, 8):
            p0 = matvec.products
            y_s = HS @ xs[k] if op == "N" else matvec_user(HS, xs[k], op="T")
            expected += n_terms(HS) * (matvec.products - p0)
            require(bool(torch.isfinite(y_s).all()) and tuple(y_s.shape) == (n, k),
                    f"symmetric H @ x {op} k={k}: shape or non-finite")
            sym_err[f"{op}/k{k}"] = rel_rows(y_s, xs[k])
    for k in (1, 8):
        xc = xs[k][perm8]
        y_n, y_t = torch.zeros_like(xc), torch.zeros_like(xc)
        for hp in block_rows:
            r0, m = hp.t_root_off, hp.shape[0]
            p0 = matvec.products
            y_n[r0 : r0 + m] = matvec(hp, xc, op="N")  # N on the global x, stacked
            y_t += matvec(hp, xc[r0 : r0 + m], op="T")  # T on the local slice, summed
            expected += n_terms(hp) * (matvec.products - p0)
        for op, yc in (("N", y_n), ("T", y_t)):
            y_u = torch.empty_like(yc)
            y_u[perm8] = yc
            row_err[f"{op}/k{k}"] = rel_rows(y_u, xs[k])
    # a float64 x, as NumPy hands one over: the kernels run on float64 copies
    y_64 = HS @ xs[1].double()
    expected += n_terms(HS)
    sym_err["N/k1/f64"] = rel_rows(y_64, xs[1])
    require(y_64.dtype == torch.float64, "float64 product dtype")
    sync()
    collect_launches()
    dense_launches, lr_launches = dense_bucket_matvec.launches, lr_bucket_matvec.launches
    unplanned_products, tiled_in_unplanned = matvec.products, tiled_bucket_matvec.launches

    # products in cluster numbering at k = 1 and 8, kernels and plain versions
    def time_products(h, xr, reps=iters):
        y = matvec(h, xr)
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            matvec(h, xr)
        sync()
        return (time.perf_counter() - t0) / reps, y

    prod_ms, prod_vs_plain = {}, {}
    for k in (1, 8):
        t_k, y_k = time_products(HS, xs[k])
        linalg.dense_bucket_matvec = dense_bucket_matvec_reference
        linalg.lr_bucket_matvec = lr_bucket_matvec_reference
        try:
            t_p, y_p = time_products(HS, xs[k])
        finally:
            linalg.dense_bucket_matvec = dense_bucket_matvec
            linalg.lr_bucket_matvec = lr_bucket_matvec
        prod_ms[f"k{k}"] = 1e3 * t_k
        prod_ms[f"k{k}_plain"] = 1e3 * t_p
        prod_vs_plain[f"k{k}"] = float(torch.linalg.norm(y_k - y_p) / torch.linalg.norm(y_p))
    hs_buckets = HS.dense_buckets + HS.lr_buckets
    # bytes a product must read: every term streams its bucket's blocks once
    bytes_per_product = sum(
        (1 + bool(b.mirror)) * 4 * (b.data.numel() if isinstance(b, ht.DenseBucket)
                                    else b.U.numel() + b.V.numel()) for b in hs_buckets)
    info_s = ht.hmatrix_info(HS)
    emit(dict(
        phase="unplanned_path", n=n, partitions=P8, symmetry="S", UPLO="L",
        assembly_s=t_asm_sym, block_rows_assembly_s=t_rows,
        compression_ratio=info_s["compression_ratio"], rank_max=info_s["rank_max"],
        n_dense_buckets=len(HS.dense_buckets), n_lr_buckets=len(HS.lr_buckets),
        terms_per_product=n_terms(HS), block_row_terms=[n_terms(h) for h in block_rows],
        block_row_sizes=[h.shape[0] for h in block_rows],
        rel_error=sym_err, block_rows_rel_error=row_err,
        products=unplanned_products, dense_launches=dense_launches, lr_launches=lr_launches,
        expected_launches=expected, tiled_launches=tiled_in_unplanned,
        product_ms=prod_ms, kernel_vs_plain_rel=prod_vs_plain,
        bytes_per_product=bytes_per_product, floor_ms_at_3_35_TBps=bytes_per_product / 3.35e9,
    ))
    require(max(sym_err.values()) < eps, f"symmetric H @ x rel error {sym_err}")
    require(max(row_err.values()) < eps, f"block rows rel error {row_err}")
    require(tiled_in_unplanned == 0, "an unplanned product launched the tiled kernel")
    require(dense_launches > 0 and lr_launches > 0 and dense_launches + lr_launches == expected,
            f"unplanned launches {dense_launches} + {lr_launches} != terms x products {expected}")
    require(max(prod_vs_plain.values()) < 1e-5, f"product kernel vs plain {prod_vs_plain}")

    # ---------------- 8. unplanned kernels vs plain, per bucket term ----------------
    def terms_of(h, op):
        """Each bucket term of op(h) with the wrapper arguments matvec gives it."""
        m_pad, n_pad = (h.shape[0] + linalg._pad_in_of(h), h.shape[1] + linalg._pad_in_of(h))
        in_len, out_len = (n_pad, m_pad) if op == "N" else (m_pad, n_pad)
        for bi, bucket in enumerate(h.dense_buckets + h.lr_buckets):
            for in_side, out_side, mode, is_mirror in linalg._bucket_terms(bucket, op, h.symmetry):
                in_off, out_off, in_root, out_root = linalg._term_offsets(
                    h, bucket, in_side, out_side, is_mirror)
                yield bi, bucket, in_len, dict(
                    in_off=in_off, out_off=out_off, trans=mode in ("T", "C"),
                    conj=h.dtype.is_complex and mode in ("C", "conj"), out_len=out_len,
                    in_root=in_root, out_root=out_root)

    def run_term(fn, blocks, xp, kw, split=None):
        extra = {} if split is None else dict(split=split)  # lr_bucket_matvec's route
        return fn(*blocks, kw["in_off"], kw["out_off"], xp, kw["trans"], kw["out_len"],
                  in_root=kw["in_root"], out_root=kw["out_root"], conj=kw.get("conj", False),
                  **extra)

    def compare_term(kernel, plain, blocks, xp, kw, what, main=True):
        """Kernel vs plain version of one unplanned term; a low-rank term
        also through its one-launch and its two-stage kernel, whichever the
        wrapper's rule picks.  Returns the worst relative error."""
        yr = run_term(plain, blocks, xp, kw)
        worst_r = 0.0
        for split in ((None, False, True) if kernel is lr_bucket_matvec else (None,)):
            yk = run_term(kernel, blocks, xp, kw, split)
            sync()
            require(bool(torch.isfinite(yk).all()), f"non-finite kernel output {what}")
            r = float(torch.linalg.norm(yk - yr) / torch.linalg.norm(yr).clamp_min(1e-300))
            require(r <= tol_rel[xp.dtype], f"{what} split={split}: rel {r:.3e}")
            worst_r = max(worst_r, r)
            if main and split is None:
                st = stat(kernel.__name__, xp.dtype)
                st["max_abs_err"] = max(st["max_abs_err"], float((yk - yr).abs().max()))
        return worst_r

    def time_term(kernel, plain, blocks, xp, kw):
        """(kernel ms, plain ms, ms by route) of one unplanned term; at k = 8
        and k = 1 the term is added to its entry point's sums."""
        tk = event_ms(lambda: run_term(kernel, blocks, xp, kw))
        tp = event_ms(lambda: run_term(plain, blocks, xp, kw))
        by_route = {}
        if kernel is lr_bucket_matvec:
            by_route = {name: event_ms(lambda sp=sp: run_term(kernel, blocks, xp, kw, sp))
                        for name, sp in (("one_launch", False), ("two_stage", True))}
        if xp.shape[1] in (1, 8):
            bm, bn = blocks[0].shape[1], blocks[-1].shape[2]
            account(kernel.__name__, blocks, xp, kw["out_len"], kw["in_off"] - kw["in_root"],
                    bm if kw["trans"] else bn, kw["trans"], kw.get("conj", False), tk, tp)
        return tk, tp, by_route

    u_worst = {}
    u_total = {(bkind, k, w): 0.0 for bkind in ("dense", "lr") for k in (1, 8)
               for w in ("kernel", "plain")}
    u_rows = []
    row_p = block_rows[P8 // 2]
    for name, h in (("H", HS), (f"block_row_{P8 // 2}", row_p)):
        for op in ("N", "T"):
            for bi, bucket, in_len, kw in terms_of(h, op):
                is_dense = isinstance(bucket, ht.DenseBucket)
                bkind = "dense" if is_dense else "lr"
                kernel, plain = ((dense_bucket_matvec, dense_bucket_matvec_reference) if is_dense
                                 else (lr_bucket_matvec, lr_bucket_matvec_reference))
                for dtype in (torch.float32, torch.float64):
                    blocks = [bucket.data.to(dtype)] if is_dense else [bucket.U.to(dtype),
                                                                       bucket.V.to(dtype)]
                    for k in (1, 8):
                        xp = torch.randn((in_len, k), dtype=dtype, device=dev)
                        key = f"{dtype}/trans{int(kw['trans'])}/k{k}/{bkind}"
                        r = compare_term(kernel, plain, blocks, xp, kw,
                                         f"{name} op {op} bucket {bi} {key}")
                        u_worst[key] = max(u_worst.get(key, 0.0), r)
                        if name == "H" and op == "N":  # the terms of H @ x
                            tk, tp, by_route = time_term(kernel, plain, blocks, xp, kw)
                            if dtype == torch.float32:
                                u_total[(bkind, k, "kernel")] += tk
                                u_total[(bkind, k, "plain")] += tp
                            u_rows.append(dict(
                                bucket=bi, kind=bkind, dtype=str(dtype), n_blocks=bucket.n_blocks,
                                block_shape=bucket.block_shape, mirror=bool(bucket.mirror),
                                rank=None if is_dense else bucket.rank_padded,
                                trans=bool(kw["trans"]), k=k, kernel_ms=tk, plain_ms=tp,
                                route_ms=by_route))
                    del blocks
    u_abs = {"dense": stats[("dense_bucket_matvec", torch.float32)]["max_abs_err"],
             "lr": stats[("lr_bucket_matvec", torch.float32)]["max_abs_err"]}
    # shapes past the main path's, with root offsets on both sides
    def unplanned_edges(dtypes, conjs=(False,)):
        worst_of = {}
        for bkind, (bm, bn, r, nb) in EDGE_SHAPES:
            kernel, plain = ((dense_bucket_matvec, dense_bucket_matvec_reference)
                             if bkind == "dense"
                             else (lr_bucket_matvec, lr_bucket_matvec_reference))
            for dtype in dtypes:
                blocks = ([randn(nb, bm, bn, dtype=dtype)] if bkind == "dense"
                          else [randn(nb, bm, r, dtype=dtype), randn(nb, r, bn, dtype=dtype)])
                for trans in (False, True):
                    in_w, out_w = (bm, bn) if trans else (bn, bm)
                    root = 777
                    kw = dict(in_off=root + torch.randint(0, L - in_w, (nb,), device=dev,
                                                          generator=gen_r),
                              out_off=root + torch.randint(0, L - out_w, (nb,), device=dev,
                                                           generator=gen_r),
                              trans=trans, out_len=L, in_root=root, out_root=root)
                    for conj in conjs:
                        for k in EDGE_KS:
                            key = f"{dtype}/trans{int(trans)}/conj{int(conj)}/{bm}x{bn}r{r}"
                            worst_of[key] = max(worst_of.get(key, 0.0), compare_term(
                                kernel, plain, blocks, randn(L, k, dtype=dtype),
                                dict(kw, conj=conj), f"edge {key} k={k}", main=False))
                del blocks
        return worst_of

    u_edge = unplanned_edges((torch.float32, torch.float64))
    emit(dict(phase="unplanned_kernel_vs_plain", tolerance_rel=dict(float32=1e-5, float64=1e-12),
              worst_rel=u_worst, max_abs_err_f32=u_abs,
              terms_k1_ms={kd: u_total[(kd, 1, "kernel")] for kd in ("dense", "lr")},
              terms_k1_plain_ms={kd: u_total[(kd, 1, "plain")] for kd in ("dense", "lr")},
              terms_k8_ms={kd: u_total[(kd, 8, "kernel")] for kd in ("dense", "lr")},
              terms_k8_plain_ms={kd: u_total[(kd, 8, "plain")] for kd in ("dense", "lr")},
              edge_shapes=edge_shapes, edge_ks=EDGE_KS, edge_worst_rel=u_edge))
    if args.out:
        with open(os.path.join(args.out, "chip_smoke_unplanned_terms.json"), "w") as f:
            json.dump(dict(nvidia_smi=smi, n=n, rows=u_rows), f, indent=1)

    # ---------------- 9. compressors ----------------
    nc = args.compress_n
    pts_c = create_sphere(nc, seed=args.seed)
    pts_cd = torch.as_tensor(pts_c.astype(np.float32), device=dev)
    gen_c = ht.KernelGenerator(laplace_kernel_symmetric, pts_cd, pts_cd)
    tree_c = ht.build_cluster_tree(pts_c, max_leaf_size=256)
    sub_c = torch.as_tensor(rng.choice(nc, 256, replace=False), device=dev)
    A_c = gen_c.block(sub_c, torch.arange(nc, device=dev)).double()
    x_c = torch.as_tensor(rng.randn(nc, 2).astype(np.float32), device=dev)
    for compressor, recompress in (("full_aca", False), ("svd", False), ("partial_aca", True)):
        t0 = time.perf_counter()
        Hc = ht.build_hmatrix(gen_c, tree_c, epsilon=eps, eta=10.0, compressor=compressor,
                              recompress=recompress)
        sync()
        t_c = time.perf_counter() - t0
        ref = A_c @ x_c.double()
        err = float(torch.linalg.norm((Hc @ x_c)[sub_c].double() - ref) / torch.linalg.norm(ref))
        info_c = ht.hmatrix_info(Hc)
        emit(dict(phase="compressors", n=nc, compressor=compressor, recompress=recompress,
                  assembly_s=t_c, rel_error=err, compression_ratio=info_c["compression_ratio"],
                  rank_mean=info_c["rank_mean"], rank_max=info_c["rank_max"],
                  n_low_rank_blocks=info_c["n_low_rank_blocks"],
                  n_false_positive=info_c["n_false_positive"]))
        require(err < eps, f"{compressor} recompress={recompress}: rel error {err:.3e}")
        require(info_c["n_low_rank_blocks"] > 0, f"{compressor}: no low-rank blocks")
        del Hc

    # ---------------- 10. profile of the unplanned products ----------------
    x8c = xs[8][perm8]
    emit(dict(phase="profile", **profile_window(
        "unplanned_matvec_k8_x20", lambda: [matvec(HS, x8c) for _ in range(iters)])))

    # ---------------- 11. complex main path ----------------
    del block_rows, row_p, unplanned
    torch.cuda.empty_cache()
    plain_versions = ((tiled_ops, "tiled_bucket_matvec_reference"),
                      (bucket_ops, "dense_bucket_matvec_reference"),
                      (bucket_ops, "lr_bucket_matvec_reference"))
    plain_originals = [getattr(mod, name) for mod, name in plain_versions]
    plain_calls = [0]

    def watch_plain(on):
        """Count the calls a wrapper makes to its plain version (none, on a
        CUDA tensor)."""
        for (mod, name), fn in zip(plain_versions, plain_originals):
            def counted(*a, _fn=fn, **kw):
                plain_calls[0] += 1
                return _fn(*a, **kw)

            setattr(mod, name, counted if on else fn)
        if on:
            plain_calls[0] = 0

    def crandn(*shape, dtype=torch.complex64):
        real = torch.float32 if dtype == torch.complex64 else torch.float64
        a = rng.randn(*shape, 2).astype(np.float32 if real == torch.float32 else np.float64)
        return torch.view_as_complex(torch.as_tensor(a, device=dev))

    def rel(a, ref):
        return float(torch.linalg.norm(a.to(ref.dtype) - ref) / torch.linalg.norm(ref))

    sub_t = torch.as_tensor(sub, device=dev)
    all_t = torch.arange(n, device=dev)

    def oracle(gen_x, xr):
        """A x, Aᵀ x and Aᴴ x on the 256 sampled rows, from generator rows
        and columns in complex128."""
        xd = xr.to(torch.complex128)
        rows_x = gen_x.block(sub_t, all_t).to(torch.complex128)
        cols_x = gen_x.block(all_t, sub_t).to(torch.complex128)
        return {"N": rows_x @ xd, "T": cols_x.T @ xd, "C": cols_x.conj().T @ xd}

    gen_c = ht.KernelGenerator(laplace_kernel_complex_symmetric, pts_d, pts_d)
    require(gen_c.dtype == torch.complex64, "complex64 generator from float32 points")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    watch_plain(True)
    t0 = time.perf_counter()
    Hc = ht.build_hmatrix(gen_c, tree, epsilon=eps, eta=10.0)
    sync()
    t_asm_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepare_tiled_matvec(Hc)
    sync()
    t_prep_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver_c = DDMSolver(Hc, gen_c, tree, schwarz="ras", overlap_radius=0.02,
                         local_solver="dense")
    t_facto_c = time.perf_counter() - t0
    mu = 8
    Bc = Hc @ crandn(n, mu)
    solves_c = {}
    # block_gmres three times: the kernels' atomics reorder the sums from run
    # to run, and the iteration count should not depend on that
    for krylov, restart, repeats in (("block_gmres", 20, 3), ("gmres", 60, 1)):
        counts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            Xs, inf = solver_c.solve(Bc, tol=tol, krylov=krylov, restart=restart, maxiter=200)
            t_s = time.perf_counter() - t0
            counts.append(inf["Nb_it"])
        res_cols = torch.linalg.norm(Hc @ Xs - Bc, dim=0) / torch.linalg.norm(Bc, dim=0)
        solves_c[krylov] = dict(iterations=inf["Nb_it"], iterations_of_each_solve=counts,
                                converged=inf["Converged"], solve_s=t_s,
                                true_residual=float(res_cols.max()),
                                reported_residual=inf["Residual"])
        require(tuple(Xs.shape) == (n, mu) and Xs.dtype == torch.complex64
                and bool(torch.isfinite(Xs).all()), f"{krylov}: solution shape, dtype, finite")
    # the real flagship's x on the complex operator: (1+i) A x = (1+i) b is the
    # real system times a scalar, so GMRES should take the real flagship's
    # iterations; another count would point at a conjugation slip
    x_same, inf_same = solver_c.solve(Hc @ x_true, tol=tol, krylov="gmres", restart=60,
                                      maxiter=200)
    same_rhs = dict(iterations=inf_same["Nb_it"], converged=inf_same["Converged"],
                    error_vs_x_true=rel(x_same, x_true.to(torch.complex64)))
    xc8 = crandn(n, 8)
    ref_c = oracle(gen_c, xc8)
    err_c = {op: rel(matvec_user(Hc, xc8, op=op)[sub_t], ref_c[op]) for op in ("N", "T", "C")}
    y128 = matvec_user(Hc, xc8[:, :1].to(torch.complex128))  # the complex128 entry point
    err_c["N/c128"] = rel(y128[sub_t], ref_c["N"][:, :1])
    sync()
    collect_split(sum(isinstance(b.plan_t, SplitPlan) for b in Hc.lr_buckets),
                  len(Hc.dense_buckets) + len(Hc.lr_buckets))
    collect_launches()
    watch_plain(False)
    buckets_c = Hc.dense_buckets + Hc.lr_buckets
    terms_c = len(buckets_c)
    launches_c, products_c = tiled_bucket_matvec.launches, matvec.products
    by_dtype_c = dict(tiled_bucket_matvec.launches_by_dtype)
    unplanned_in_c = dense_bucket_matvec.launches + lr_bucket_matvec.launches
    plain_calls_c = plain_calls[0]
    peak_c = torch.cuda.max_memory_allocated()
    info_c64 = ht.hmatrix_info(Hc)

    # products in cluster numbering, kernel and plain version
    prod_c = {}
    for k in (1, 8):
        xr = crandn(n, k)
        t_k, y_k = time_products(Hc, xr)
        linalg.tiled_bucket_matvec = tiled_bucket_matvec_reference
        try:
            t_p, y_p = time_products(Hc, xr, reps=5)
        finally:
            linalg.tiled_bucket_matvec = tiled_bucket_matvec
        prod_c[f"k{k}"] = 1e3 * t_k
        prod_c[f"k{k}_plain"] = 1e3 * t_p
        prod_c[f"k{k}_kernel_vs_plain_rel"] = rel(y_k, y_p)
        del y_k, y_p
    bytes_c = sum(8 * (b.data.numel() if isinstance(b, ht.DenseBucket)
                       else b.U.numel() + b.V.numel()) for b in buckets_c)
    emit(dict(
        phase="complex_main_path", n=n, dtype="complex64", subdomains=P, epsilon=eps, tol=tol,
        right_hand_sides=mu, assembly_s=t_asm_c, aca_s=Hc.info["aca_walltime"],
        prepare_s=t_prep_c, facto_s=t_facto_c, solves=solves_c,
        real_flagship_gmres_iterations=infos["Nb_it"], reference_iterations=ref_iters,
        gmres_on_real_flagship_x=same_rhs,
        compression_ratio=info_c64["compression_ratio"], rank_mean=info_c64["rank_mean"],
        rank_max=info_c64["rank_max"], real_flagship_rank_mean=info["rank_mean"],
        n_false_positive=info_c64["n_false_positive"],
        n_dense_buckets=len(Hc.dense_buckets), n_lr_buckets=len(Hc.lr_buckets),
        matvec_rel_error=err_c, product_ms=prod_c, bytes_per_product=bytes_c,
        floor_ms_at_3_35_TBps=bytes_c / 3.35e9, max_memory_allocated_bytes=peak_c,
        launches=launches_c, products=products_c, bucket_terms=terms_c,
        launches_by_dtype={str(d): c for d, c in by_dtype_c.items()},
        plain_version_calls=plain_calls_c,
    ))
    require(Hc.dtype == torch.complex64 and Hc.symmetry == "N", "complex64 non-symmetric H-matrix")
    require(all(b.plan_t is not None and b.plan_s is not None for b in buckets_c), "complex plans")
    require(max(err_c.values()) < eps, f"complex matvec rel error {err_c}")
    for krylov, r in solves_c.items():
        require(r["converged"] and r["true_residual"] < 10 * tol,
                f"complex {krylov}: true residual {r['true_residual']:.3e} >= 10*tol")
    require(launches_c > 0 and launches_c == terms_c * products_c,
            f"complex launches {launches_c} != bucket terms {terms_c} x products {products_c}")
    require(by_dtype_c.get(torch.complex128) == terms_c
            and by_dtype_c.get(torch.complex64) == launches_c - terms_c,
            f"complex launches by dtype {by_dtype_c}")
    require(unplanned_in_c == 0, "a planned complex product launched an unplanned kernel")
    require(plain_calls_c == 0, f"a complex product called a plain version {plain_calls_c} times")
    require(max(prod_c[f"k{k}_kernel_vs_plain_rel"] for k in (1, 8)) < 1e-5,
            f"complex product kernel vs plain {prod_c}")

    # ---------------- 12. hermitian unplanned path ----------------
    del solver_c, Xs, Bc, x_same
    gen_h = ht.KernelGenerator(laplace_kernel_hermitian, pts_d, pts_d)
    reset_counts()
    watch_plain(True)
    t0 = time.perf_counter()
    HH = ht.build_hmatrix(gen_h, tree8, epsilon=eps, eta=10.0, symmetry="H", UPLO="L")
    sync()
    t_asm_h = time.perf_counter() - t0
    buckets_h = HH.dense_buckets + HH.lr_buckets
    xh = {k: crandn(n, k) for k in (1, 8)}
    ref_h = {k: oracle(gen_h, xh[k]) for k in (1, 8)}
    err_h = {}
    for op in ("N", "T", "C"):
        for k in (1, 8):
            y_h = HH @ xh[k] if op == "N" else matvec_user(HH, xh[k], op=op)
            require(bool(torch.isfinite(y_h).all()) and tuple(y_h.shape) == (n, k),
                    f"hermitian H @ x {op} k={k}: shape or non-finite")
            err_h[f"{op}/k{k}"] = rel(y_h[sub_t], ref_h[k][op])
    err_h["N/k1/c128"] = rel((HH @ xh[1].to(torch.complex128))[sub_t], ref_h[1]["N"])
    sync()
    collect_launches()
    watch_plain(False)
    launches_h = (dense_bucket_matvec.launches, lr_bucket_matvec.launches)
    by_dtype_h = {w.__name__: {str(d): c for d, c in w.launches_by_dtype.items()}
                  for w in (dense_bucket_matvec, lr_bucket_matvec)}
    products_h, tiled_in_h, plain_calls_h = matvec.products, tiled_bucket_matvec.launches, \
        plain_calls[0]
    prod_h = {}
    perm8_c = {k: xh[k][perm8] for k in (1, 8)}
    for k in (1, 8):
        t_k, y_k = time_products(HH, perm8_c[k])
        linalg.dense_bucket_matvec = dense_bucket_matvec_reference
        linalg.lr_bucket_matvec = lr_bucket_matvec_reference
        try:
            t_p, y_p = time_products(HH, perm8_c[k], reps=5)
        finally:
            linalg.dense_bucket_matvec = dense_bucket_matvec
            linalg.lr_bucket_matvec = lr_bucket_matvec
        prod_h[f"k{k}"] = 1e3 * t_k
        prod_h[f"k{k}_plain"] = 1e3 * t_p
        prod_h[f"k{k}_kernel_vs_plain_rel"] = rel(y_k, y_p)
        del y_k, y_p
    bytes_h = sum((1 + bool(b.mirror)) * 8 * (b.data.numel() if isinstance(b, ht.DenseBucket)
                                              else b.U.numel() + b.V.numel()) for b in buckets_h)
    info_h = ht.hmatrix_info(HH)
    emit(dict(
        phase="hermitian_unplanned_path", n=n, dtype="complex64", partitions=P8, symmetry="H",
        UPLO="L", assembly_s=t_asm_h, compression_ratio=info_h["compression_ratio"],
        rank_max=info_h["rank_max"], n_dense_buckets=len(HH.dense_buckets),
        n_lr_buckets=len(HH.lr_buckets), terms_per_product=n_terms(HH), rel_error=err_h,
        products=products_h, dense_launches=launches_h[0], lr_launches=launches_h[1],
        launches_by_dtype=by_dtype_h, tiled_launches=tiled_in_h,
        plain_version_calls=plain_calls_h, product_ms=prod_h, bytes_per_product=bytes_h,
        floor_ms_at_3_35_TBps=bytes_h / 3.35e9,
    ))
    require(HH.dtype == torch.complex64 and any(b.mirror for b in buckets_h)
            and all(b.plan_t is None and b.plan_s is None for b in buckets_h),
            "hermitian H-matrix: complex64, mirror buckets, no plans")
    require(max(err_h.values()) < eps, f"hermitian H @ x rel error {err_h}")
    require(min(launches_h) > 0 and sum(launches_h) == n_terms(HH) * products_h,
            f"hermitian launches {launches_h} != terms {n_terms(HH)} x products {products_h}")
    require(tiled_in_h == 0 and plain_calls_h == 0,
            "a hermitian product launched the tiled kernel or called a plain version")
    require(max(prod_h[f"k{k}_kernel_vs_plain_rel"] for k in (1, 8)) < 1e-5,
            f"hermitian product kernel vs plain {prod_h}")

    # ---------------- 13. complex kernels vs plain ----------------
    # planned terms of the complex flagship: both sides, plain and conjugated
    # (B, Bᵀ, conj(B), Bᴴ); unplanned terms of the hermitian H-matrix: the same
    # four on every bucket.  Timed: the terms of H @ x.
    c_worst, c_rows = {}, []
    m_pad_c = Hc.shape[0] + linalg._pad_in_of(Hc)
    for bi, bucket in enumerate(buckets_c):
        is_dense = isinstance(bucket, ht.DenseBucket)
        for dtype in (torch.complex64, torch.complex128):
            bk = bucket
            if dtype == torch.complex128:
                bk = (dataclasses.replace(bucket, data=bucket.data.to(dtype)) if is_dense else
                      dataclasses.replace(bucket, U=bucket.U.to(dtype), V=bucket.V.to(dtype)))
            for side in ("t", "s"):
                routes, picked = routes_of(bk, side, m_pad_c)
                if dtype == torch.complex64:  # the main path's own plan for the picked route
                    routes[picked] = getattr(bucket, f"plan_{side}")
                ref_plan = next(iter(routes.values()))
                for conj in (False, True):
                    for k in (1, 8):
                        xp = crandn(m_pad_c, k, dtype=dtype)
                        for route, plan in routes.items():
                            key = f"tiled/{dtype}/{side}/conj{int(conj)}/k{k}/{route}"
                            c_worst[key] = max(c_worst.get(key, 0.0), compare(
                                plan, xp, f"bucket {bi} {key}", conj=conj, ref_plan=ref_plan,
                                main=route == picked))
                        if side == "t" and not conj:
                            ms, tp = time_tiled(routes, picked, bk, side, xp)
                            c_rows.append(dict(
                                path="complex_main_path", kernel="tiled", dtype=str(dtype),
                                bucket=bi, kind="dense" if is_dense else "lr",
                                n_blocks=bucket.n_blocks, block_shape=bucket.block_shape,
                                rank=None if is_dense else bucket.rank_padded,
                                trans=False, conj=False, k=k, route=picked, route_ms=ms,
                                kernel_ms=ms[picked], plain_ms=tp))
            del bk, routes
    hh_timed = {(bi, kw["trans"], kw["conj"]) for bi, _, _, kw in terms_of(HH, "N")}
    pad_h = HH.shape[0] + linalg._pad_in_of(HH)
    for bi, bucket in enumerate(buckets_h):
        is_dense = isinstance(bucket, ht.DenseBucket)
        kernel, plain = ((dense_bucket_matvec, dense_bucket_matvec_reference) if is_dense
                         else (lr_bucket_matvec, lr_bucket_matvec_reference))
        for dtype in (torch.complex64, torch.complex128):
            blocks = [bucket.data.to(dtype)] if is_dense else [bucket.U.to(dtype),
                                                               bucket.V.to(dtype)]
            for trans in (False, True):
                in_off, out_off = ((bucket.t_off, bucket.s_off) if trans
                                   else (bucket.s_off, bucket.t_off))
                for conj in (False, True):
                    kw = dict(in_off=in_off, out_off=out_off, trans=trans, conj=conj,
                              out_len=pad_h, in_root=0, out_root=0)
                    for k in (1, 8):
                        xp = crandn(pad_h, k, dtype=dtype)
                        key = (f"unplanned/{dtype}/trans{int(trans)}/conj{int(conj)}/k{k}/"
                               f"{'dense' if is_dense else 'lr'}")
                        c_worst[key] = max(c_worst.get(key, 0.0), compare_term(
                            kernel, plain, blocks, xp, kw, f"hermitian bucket {bi} {key}"))
                        if (bi, trans, conj) in hh_timed:
                            tk, tp, by_route = time_term(kernel, plain, blocks, xp, kw)
                            c_rows.append(dict(
                                path="hermitian_unplanned_path", kernel="unplanned",
                                dtype=str(dtype), bucket=bi,
                                kind="dense" if is_dense else "lr", n_blocks=bucket.n_blocks,
                                block_shape=bucket.block_shape, mirror=bool(bucket.mirror),
                                rank=None if is_dense else bucket.rank_padded,
                                trans=trans, conj=conj, k=k, kernel_ms=tk, plain_ms=tp,
                                route_ms=by_route))
            del blocks
    complex_dtypes = (torch.complex64, torch.complex128)
    c_edges = dict(tiled=tiled_edges(complex_dtypes, conjs=(False, True)),
                   unplanned=unplanned_edges(complex_dtypes, conjs=(False, True)))

    # a real H-matrix on a complex x: the real kernels on x viewed as 2k real
    # columns, without plans and with them
    real_on_complex = {}
    xrc = crandn(n, 4)
    ref_rc = A_rows.to(torch.complex128) @ xrc.to(torch.complex128)
    for planned in (False, True):
        if planned:
            prepare_tiled_matvec(HS)
        reset_counts()
        watch_plain(True)
        y_rc = matvec_user(HS, xrc)
        watch_plain(False)
        counts = {w.__name__: dict(w.launches_by_dtype) for w in wrappers}
        used = ("tiled_bucket_matvec",) if planned else ("dense_bucket_matvec",
                                                        "lr_bucket_matvec")
        require(all(set(counts[w]) <= {torch.float32} for w in counts)
                and sum(sum(counts[w].values()) for w in used) == n_terms(HS)
                and sum(sum(c.values()) for c in counts.values()) == n_terms(HS)
                and plain_calls[0] == 0,
                f"real H on complex x (planned={planned}): launches {counts}, "
                f"plain calls {plain_calls[0]}")
        saved = {name: getattr(linalg, name) for name in counts}
        linalg.tiled_bucket_matvec = tiled_bucket_matvec_reference
        linalg.dense_bucket_matvec = dense_bucket_matvec_reference
        linalg.lr_bucket_matvec = lr_bucket_matvec_reference
        try:
            y_rc_plain = matvec_user(HS, xrc)
        finally:
            for name, fn in saved.items():
                setattr(linalg, name, fn)
        real_on_complex["planned" if planned else "unplanned"] = dict(
            rel_error=rel(y_rc[sub_t], ref_rc), kernel_vs_plain_rel=rel(y_rc, y_rc_plain))
        require(y_rc.dtype == torch.complex64, "real H on complex64 x: dtype")
    for b in HS.dense_buckets + HS.lr_buckets:
        b.plan_t = b.plan_s = None
    emit(dict(phase="complex_kernel_vs_plain",
              tolerance_rel=dict(complex64=1e-5, complex128=1e-12), worst_rel=c_worst,
              edge_shapes=edge_shapes, edge_ks=EDGE_KS, edge_worst_rel=c_edges,
              real_hmatrix_on_complex_x=real_on_complex))
    require(all(v["rel_error"] < eps and v["kernel_vs_plain_rel"] < 1e-5
                for v in real_on_complex.values()), f"real H on complex x {real_on_complex}")
    if args.out:
        with open(os.path.join(args.out, "chip_smoke_complex_terms.json"), "w") as f:
            json.dump(dict(nvidia_smi=smi, n=n, rows=c_rows), f, indent=1)

    # ---------------- 14. profile of the complex products ----------------
    xc8c = xc8[torch.as_tensor(tree.permutation, device=dev)]
    emit(dict(phase="profile", **profile_window(
        "complex_matvec_k8_x20", lambda: [matvec(Hc, xc8c) for _ in range(iters)])))

    # ---------------- 15. the per-call floor ----------------
    # one wrapper call on a bucket of one tiny block: on the host clock over
    # 1,000 calls (what the call costs the host) and between CUDA events (the
    # rate at which such calls leave the device's queue)
    tiny_d = ht.DenseBucket(data=randn(1, 8, 8, dtype=torch.float32),
                            t_off=torch.zeros(1, dtype=torch.int64, device=dev),
                            s_off=torch.full((1,), 8, dtype=torch.int64, device=dev))
    tiny_l = ht.LowRankBucket(U=randn(1, 8, 4, dtype=torch.float32),
                              V=randn(1, 4, 8, dtype=torch.float32),
                              t_off=tiny_d.t_off, s_off=tiny_d.s_off)
    x_t, y_t = randn(64, 1, dtype=torch.float32), torch.zeros((64, 1), device=dev)
    floor_calls = {
        "tiled_dense": lambda pl=build_tile_plan(tiny_d, "t", 64): tiled_bucket_matvec(
            pl, x_t, out=y_t),
        "tiled_lr_one_launch": lambda pl=build_tile_plan(tiny_l, "t", 64): tiled_bucket_matvec(
            pl, x_t, out=y_t),
        "tiled_lr_split": lambda pl=build_tile_plan_lr_split(tiny_l, "t", 64):
            tiled_bucket_matvec(pl, x_t, out=y_t),
        "unplanned_dense": lambda: dense_bucket_matvec(
            tiny_d.data, tiny_d.s_off, tiny_d.t_off, x_t, False, 64, out=y_t),
        "unplanned_lr_one_launch": lambda: lr_bucket_matvec(
            tiny_l.U, tiny_l.V, tiny_l.s_off, tiny_l.t_off, x_t, False, 64, out=y_t, split=False),
        "unplanned_lr_two_stage": lambda: lr_bucket_matvec(
            tiny_l.U, tiny_l.V, tiny_l.s_off, tiny_l.t_off, x_t, False, 64, out=y_t, split=True),
        "torch_add_": lambda: y_t.add_(1.0),
    }
    floor = {}
    for name, fn in floor_calls.items():
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        host_us = 1e3 * (time.perf_counter() - t0)
        sync()
        floor[name] = dict(host_us_per_call=host_us, device_us_per_call=1e3 * event_ms(fn, 1000))
    emit(dict(phase="per_call_floor", calls=1000, per_call=floor))
    require(bool(torch.isfinite(y_t).all()), "per-call floor: non-finite output")

    # ---------------- the kernels line ----------------
    csrc = "htool_tpu_torch/csrc/"
    # name: (entry point, source, all sources, the TPU kernel's pallas_call)
    sources = {
        "tiled_bucket_matvec": ("htool_stream_matvec", csrc + "stream_matvec.cu",
                                [csrc + "stream_matvec.cu", csrc + "tiled_matvec.cu",
                                 csrc + "matvec_stream.cuh", csrc + "matvec_block.cuh"],
                                "htool_tpu/ops/tiled_matvec.py:585"),
        SPLIT: ("htool_stream_matvec", csrc + "stream_matvec.cu",
                [csrc + "stream_matvec.cu", csrc + "matvec_stream.cuh"],
                "htool_tpu/ops/tiled_matvec.py:215"),
        "dense_bucket_matvec": ("htool_dense_bucket_stream", csrc + "bucket_stream.cu",
                                [csrc + "bucket_stream.cu", csrc + "matvec_stream.cuh"],
                                "htool_tpu/ops/bucket_matvec.py:179"),
        "lr_bucket_matvec": ("htool_lr_bucket_stream", csrc + "bucket_stream.cu",
                             [csrc + "bucket_stream.cu", csrc + "bucket_matvec.cu",
                              csrc + "matvec_stream.cuh", csrc + "matvec_block.cuh"],
                             "htool_tpu/ops/bucket_matvec.py:258"),
    }

    def bound_of(st, dt):
        by_bytes = 1e3 * st["bytes"] / PEAK_BYTES_S
        by_ops = 1e3 * st["flops"] / PEAK_FLOPS_S[dt]
        return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"

    kernel_rows = []
    for wname, (base, source, all_sources, replaces) in sources.items():
        for dt in DTYPES:
            name = str(dt).removeprefix("torch.")
            st = stats.get((wname, dt))
            n_launch = path_launches.get((wname, dt), 0)
            require(st is not None and st["terms"] > 0 and st["k1"]["terms"] > 0,
                    f"{wname} {name}: no term was timed at k = 8 and k = 1")
            require(n_launch > 0, f"{wname} {name}: not launched on a main path")
            bound_ms, bound_by = bound_of(st, dt)
            k1_bound_ms, k1_bound_by = bound_of(st["k1"], dt)
            if dt.is_complex and wname == "tiled_bucket_matvec":
                # the complex route of the same TPU kernel (apply_complex_plans)
                replaces = "htool_tpu/ops/tiled_matvec.py:384"
            by_k = path_launches_k.get((wname, dt), {})
            kernel_rows.append(dict(
                name=f"{wname}[{name}]", entry_point=base + SUFFIX_OF[name], route="cuda",
                source=source, sources=all_sources, replaces=replaces, launches=n_launch,
                launches_by_k={str(k): c for k, c in sorted(by_k.items())},
                max_abs_err=st["max_abs_err"], ms=st["ms"], plain_ms=st["plain_ms"],
                bound_ms=bound_ms, bound_by=bound_by, library_ms=st["library_ms"],
                library_call="torch.bmm on windows gathered beforehand "
                             "(gather and scatter excluded)",
                terms=st["terms"], k=8,
                k1=dict(ms=st["k1"]["ms"], plain_ms=st["k1"]["plain_ms"], bound_ms=k1_bound_ms,
                        bound_by=k1_bound_by, library_ms=st["k1"]["library_ms"],
                        terms=st["k1"]["terms"])))
    emit(dict(phase="cuda_launches_on_main_paths", by_wrapper=path_cuda_launches))
    emit({"kernels": kernel_rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
