#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py            # n = 100,000, the flagship size
    python3 chip_smoke.py --n 20000  # a shorter check

Phases (each prints one JSON line):

1. device — the card, and ``nvidia-smi``'s name and power limit line;
2. build — the tiled CUDA kernel is compiled from ``htool_tpu_torch/csrc``;
3. main path — sphere → cluster tree → H-matrix (f32, Laplace kernel, leaf
   256, ε = 1e-3, η = 10) → tiled plans → one-level RAS (64 subdomains,
   overlap 0.02, dense local solves) → restarted GMRES(60) to 1e-6, twice,
   then once more with a float64 NumPy right-hand side (GMRES in float64,
   every product still through the kernel); the matvec at k = 8 is timed
   with the kernel and with its plain version, and checked against
   generator rows; assembly and the Schwarz set-up are timed again warm;
4. kernel vs plain — every bucket term of that H-matrix, both
   orientations, k = 1 and 8, f32 and f64, against the plain PyTorch
   version on the same CUDA tensors;
5. kernel edges — the same comparison on random buckets with shapes the
   flagship does not reach: ranks above 64, non-square and 6272-wide
   blocks, k = 2, 3, 5 and 11;
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
   one block row, both orientations, k = 1 and 8, f32 and f64, and random
   buckets of edge shapes (rank 96, 6272×2080 low-rank and 416×1568 dense
   blocks, k = 2, 3, 5, 11);
9. compressors — full ACA, SVD and partial ACA with SVD recompression at
   n = 20,000, each checked against generator rows;
10. profile — 20 unplanned products at k = 8.

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    ap.add_argument("--compress-n", type=int, default=20_000,
                    help="number of points of the compressors phase")
    ap.add_argument("--out", default=None, help="directory for the per-bucket timing tables")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import htool_tpu_torch as ht
    from htool_tpu_torch.hmatrix import linalg
    from htool_tpu_torch.hmatrix.linalg import matvec, matvec_user, prepare_tiled_matvec
    from htool_tpu_torch.kernels import build_info, load_library
    from htool_tpu_torch.ops.bucket_matvec import (
        dense_bucket_matvec,
        dense_bucket_matvec_reference,
        lr_bucket_matvec,
        lr_bucket_matvec_reference,
    )
    from htool_tpu_torch.ops.tiled_matvec import (
        build_tile_plan,
        tiled_bucket_matvec,
        tiled_bucket_matvec_reference,
    )
    from htool_tpu_torch.solvers import DDMSolver
    from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

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
    load_library()
    emit(dict(phase="build", seconds=build_info["seconds"], library=build_info["library"],
              ptxas=[l.strip() for l in build_info["ptxas"].splitlines()
                     if "registers" in l or "spill" in l]))

    # ---------------- 3. main path ----------------
    n, P, eps, tol = args.n, 64, 1e-3, 1e-6
    rng = np.random.RandomState(args.seed)
    torch.cuda.reset_peak_memory_stats()
    tiled_bucket_matvec.launches = 0
    dense_bucket_matvec.launches = lr_bucket_matvec.launches = 0
    matvec.products = 0

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
    ))
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
    tol_rel = {torch.float32: 1e-5, torch.float64: 1e-12}
    m_pad = H.shape[0] + linalg._pad_in_of(H)
    rows, worst, max_abs_err = [], {}, 0.0
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def compare(plan, xp, what):
        """Kernel vs plain version on the same CUDA tensors: (rel, max abs)."""
        yk = tiled_bucket_matvec(plan, xp)
        yr = tiled_bucket_matvec_reference(plan, xp)
        sync()
        require(bool(torch.isfinite(yk).all()), f"non-finite kernel output {what}")
        rel = float(torch.linalg.norm(yk - yr) / torch.linalg.norm(yr).clamp_min(1e-300))
        require(rel <= tol_rel[xp.dtype], f"{what}: rel {rel:.3e}")
        return rel, float((yk - yr).abs().max())

    def timed(fn, plan, xp, reps=3):
        fn(plan, xp)
        ev0.record()
        for _ in range(reps):
            fn(plan, xp)
        ev1.record()
        sync()
        return ev0.elapsed_time(ev1) / reps

    total = {(k, "kernel"): 0.0 for k in (1, 8)} | {(k, "plain"): 0.0 for k in (1, 8)}
    for bi, bucket in enumerate(buckets):
        is_dense = isinstance(bucket, ht.DenseBucket)
        for dtype in (torch.float32, torch.float64):
            bk = bucket
            if dtype == torch.float64:
                bk = (dataclasses.replace(bucket, data=bucket.data.double()) if is_dense else
                      dataclasses.replace(bucket, U=bucket.U.double(), V=bucket.V.double()))
            for side in ("t", "s"):
                plan = getattr(bucket, f"plan_{side}") if dtype == torch.float32 else \
                    build_tile_plan(bk, side, m_pad)
                for k in (1, 8):
                    xp = torch.randn((m_pad, k), dtype=dtype, device=dev)
                    key = (str(dtype), side, k, "dense" if is_dense else "lr")
                    rel, abs_err = compare(plan, xp, f"bucket {bi} {key}")
                    worst[key] = max(worst.get(key, 0.0), rel)
                    if dtype == torch.float32:
                        max_abs_err = max(max_abs_err, abs_err)
                        if side == "t":  # the main path's orientation
                            tk = timed(tiled_bucket_matvec, plan, xp)
                            tp = timed(tiled_bucket_matvec_reference, plan, xp)
                            total[(k, "kernel")] += tk
                            total[(k, "plain")] += tp
                            rows.append(dict(
                                bucket=bi, kind="dense" if is_dense else "lr",
                                n_blocks=bucket.n_blocks, block_shape=bucket.block_shape,
                                rank=None if is_dense else bucket.rank_padded,
                                n_tiles=plan.n_tiles, T=plan.T, E=plan.E, k=k,
                                kernel_ms=tk, plain_ms=tp,
                            ))
            del bk
    emit(dict(phase="kernel_vs_plain", tolerance_rel=dict(float32=1e-5, float64=1e-12),
              worst_rel={"/".join(map(str, k)): v for k, v in sorted(worst.items())},
              max_abs_err_f32=max_abs_err,
              all_terms_k1_ms=total[(1, "kernel")], all_terms_k1_plain_ms=total[(1, "plain")],
              all_terms_k8_ms=total[(8, "kernel")], all_terms_k8_plain_ms=total[(8, "plain")]))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_buckets.json"), "w") as f:
            json.dump(dict(nvidia_smi=smi, n=n, rows=rows), f, indent=1)

    # ---------------- 5. kernel vs plain past the main path's shapes ----------------
    # ranks above one shared-memory pass of the kernel (64 rows), non-square
    # and wide blocks (low-rank storage classes reach thousands of columns at
    # larger n), and k other than 1 and 8 (partial column chunks, scalar loads)
    gen_r = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape, dtype):
        return torch.randn(shape, dtype=dtype, device=dev, generator=gen_r)

    L, edge_worst = 20_000, {}
    for bkind, (bm, bn, r, nb) in (("dense", (416, 1568, 0, 96)), ("lr", (6272, 2080, 96, 48))):
        for dtype in (torch.float32, torch.float64):
            offs = dict(t_off=torch.randint(0, L - bm, (nb,), device=dev, generator=gen_r),
                        s_off=torch.randint(0, L - bn, (nb,), device=dev, generator=gen_r))
            bucket = (ht.DenseBucket(data=randn(nb, bm, bn, dtype=dtype), **offs) if bkind == "dense"
                      else ht.LowRankBucket(U=randn(nb, bm, r, dtype=dtype),
                                            V=randn(nb, r, bn, dtype=dtype), **offs))
            for side in ("t", "s"):
                plan = build_tile_plan(bucket, side, L)
                for k in (2, 3, 5, 11):
                    xp = randn(L, k, dtype=dtype)
                    key = f"{dtype}/{side}/{k}/{bkind}"
                    edge_worst[key] = compare(plan, xp, f"{key} {bm}x{bn} r={r}")[0]
            del bucket
    emit(dict(phase="kernel_edges", shapes=dict(dense=[416, 1568], lr=[6272, 2080, 96]),
              worst_rel=edge_worst))

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

    dense_bucket_matvec.launches = lr_bucket_matvec.launches = 0
    tiled_bucket_matvec.launches = 0
    matvec.products = 0
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
    sync()
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
                    in_off=in_off, out_off=out_off, trans=mode in ("T", "C"), out_len=out_len,
                    in_root=in_root, out_root=out_root)

    def run_term(fn, blocks, xp, kw):
        return fn(*blocks, kw["in_off"], kw["out_off"], xp, kw["trans"], kw["out_len"],
                  in_root=kw["in_root"], out_root=kw["out_root"])

    def compare_term(kernel, plain, blocks, xp, kw, what):
        yk = run_term(kernel, blocks, xp, kw)
        yr = run_term(plain, blocks, xp, kw)
        sync()
        require(bool(torch.isfinite(yk).all()), f"non-finite kernel output {what}")
        r = float(torch.linalg.norm(yk - yr) / torch.linalg.norm(yr).clamp_min(1e-300))
        require(r <= tol_rel[xp.dtype], f"{what}: rel {r:.3e}")
        return r, float((yk - yr).abs().max())

    def timed_term(fn, blocks, xp, kw, reps=3):
        run_term(fn, blocks, xp, kw)
        ev0.record()
        for _ in range(reps):
            run_term(fn, blocks, xp, kw)
        ev1.record()
        sync()
        return ev0.elapsed_time(ev1) / reps

    u_worst, u_abs = {}, {"dense": 0.0, "lr": 0.0}
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
                        r, a = compare_term(kernel, plain, blocks, xp, kw,
                                            f"{name} op {op} bucket {bi} {key}")
                        u_worst[key] = max(u_worst.get(key, 0.0), r)
                        if dtype == torch.float32:
                            u_abs[bkind] = max(u_abs[bkind], a)
                            if name == "H" and op == "N":  # the terms of H @ x
                                tk = timed_term(kernel, blocks, xp, kw)
                                tp = timed_term(plain, blocks, xp, kw)
                                u_total[(bkind, k, "kernel")] += tk
                                u_total[(bkind, k, "plain")] += tp
                                u_rows.append(dict(
                                    bucket=bi, kind=bkind, n_blocks=bucket.n_blocks,
                                    block_shape=bucket.block_shape, mirror=bool(bucket.mirror),
                                    rank=None if is_dense else bucket.rank_padded,
                                    trans=bool(kw["trans"]), k=k, kernel_ms=tk, plain_ms=tp))
                    del blocks
    # shapes past the main path's, with root offsets on both sides
    u_edge = {}
    for bkind, (bm, bn, r, nb) in (("dense", (416, 1568, 0, 96)), ("lr", (6272, 2080, 96, 48))):
        kernel, plain = ((dense_bucket_matvec, dense_bucket_matvec_reference) if bkind == "dense"
                         else (lr_bucket_matvec, lr_bucket_matvec_reference))
        for dtype in (torch.float32, torch.float64):
            blocks = ([randn(nb, bm, bn, dtype=dtype)] if bkind == "dense"
                      else [randn(nb, bm, r, dtype=dtype), randn(nb, r, bn, dtype=dtype)])
            for trans in (False, True):
                in_w, out_w = (bm, bn) if trans else (bn, bm)
                root = 777
                kw = dict(in_off=root + torch.randint(0, L - in_w, (nb,), device=dev, generator=gen_r),
                          out_off=root + torch.randint(0, L - out_w, (nb,), device=dev, generator=gen_r),
                          trans=trans, out_len=L, in_root=root, out_root=root)
                for k in (2, 3, 5, 11):
                    key = f"{dtype}/trans{int(trans)}/k{k}/{bkind}"
                    u_edge[key] = compare_term(kernel, plain, blocks, randn(L, k, dtype=dtype), kw,
                                               f"edge {key} {bm}x{bn} r={r}")[0]
            del blocks
    emit(dict(phase="unplanned_kernel_vs_plain", tolerance_rel=dict(float32=1e-5, float64=1e-12),
              worst_rel=u_worst, max_abs_err_f32=u_abs,
              terms_k1_ms={kd: u_total[(kd, 1, "kernel")] for kd in ("dense", "lr")},
              terms_k1_plain_ms={kd: u_total[(kd, 1, "plain")] for kd in ("dense", "lr")},
              terms_k8_ms={kd: u_total[(kd, 8, "kernel")] for kd in ("dense", "lr")},
              terms_k8_plain_ms={kd: u_total[(kd, 8, "plain")] for kd in ("dense", "lr")},
              edge_shapes=dict(dense=[416, 1568], lr=[6272, 2080, 96]), edge_worst_rel=u_edge))
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

    kernel_rows = [dict(
        name="tiled_bucket_matvec", route="cuda",
        source="htool_tpu_torch/csrc/tiled_matvec.cu",
        replaces="htool_tpu/ops/tiled_matvec.py:585",
        launches=launches, max_abs_err=max_abs_err,
        ms=total[(8, "kernel")], plain_ms=total[(8, "plain")],
    )]
    for bkind, name, line, n_launch in (("dense", "dense_bucket_matvec", 179, dense_launches),
                                       ("lr", "lr_bucket_matvec", 258, lr_launches)):
        kernel_rows.append(dict(
            name=name, route="cuda", source="htool_tpu_torch/csrc/bucket_matvec.cu",
            replaces=f"htool_tpu/ops/bucket_matvec.py:{line}", launches=n_launch,
            max_abs_err=u_abs[bkind], ms=u_total[(bkind, 8, "kernel")],
            plain_ms=u_total[(bkind, 8, "plain")]))
    emit({"kernels": kernel_rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
