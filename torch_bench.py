#!/usr/bin/env python3
"""The benchmark rows of ``bench.py``, run through the PyTorch/CUDA port.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 torch_bench.py                        # every row but blr_n10000
    python3 torch_bench.py --flat-blr             # ... and blr_n10000
    python3 torch_bench.py --rows kernel_smoke,matvec_n10000
    python3 torch_bench.py --device cpu --n 1500  # the plain versions, small

The rows are ``bench.py``'s (``_row_registry``, in ``_row_names``' order)
with its metric names and accuracy contracts:

- ``kernel_smoke``: a tiny exercise of every product route (planned dense N
  and T, planned low rank split in two stages, a planned complex64 dense
  term, the unplanned dense and low-rank terms; 8 blocks of
  256², rank 8, k = 8) against a float64 NumPy oracle, rel < 1e-4; each
  route's CUDA launches are counted and must be nonzero on the card;
- ``matvec_n10000``, ``matvec_n100000``: sphere, float32, leaf 256, ε 1e-3,
  η 10, assembly cold and warm, tiled plans, 20 products at k = 8, the rel
  error on 256 generator rows in user numbering < ε (the headline row is
  ``matvec_n10000``: compressed entries per second);
- ``complex_matvec_n100000``: the same for the complex64 kernel
  ``laplace_kernel_complex_symmetric`` through the complex tiled plans;
- ``blr_n10000`` (with ``--flat-blr``): ``build_blr`` (block 512),
  ``blr_lu`` with the error estimate, 10 solves of 8 right-hand sides;
- ``blr2_n10000``, ``blr2_n100000``: ``build_blr2`` (ε 1e-4), ``blr2_lu``
  with the error estimate, 10 solves; backward error < 100·ε;
- ``ddm_n100000``: 64 subdomains, RAS overlap 0.02, dense local solves,
  GMRES(60) to 1e-6 cold and warm, the right-hand side made by the
  compressed operator; true residual < 10·tol;
- ``ddm2_n20000``: 8 subdomains, overlap 0.05, GenEO ν = 2, local store,
  additive, beside one level;
- ``weak_scaling_static``: host accounting of the bucket entries, balance
  and collective bytes a partition for P = 1, 2, 4, 8;
- ``assembly_cold_n10000``: the first assembly of a process (its first use
  of torch's libraries and allocator on the card) and the first product
  with an empty kernel build directory (``kernel_build_s``,
  ``n_kernel_builds``: libraries compiled by ``nvcc``).

Each row runs in a subprocess of its own (``--row NAME``), which claims the
device before it starts any clock and synchronizes the device around every
timed window; it returns its results on a sentinel line.  After each row the
cumulative results go to standard error and to ``--out`` (default
``torch_bench_out/torch_bench_aux.json``), and a headline line
``{"metric": "hmatrix_matvec_compressed_entries_per_s", ...}`` goes to
standard output.  ``vs_baseline`` compares with the port's own first run on
the card (``torch_bench_baseline.json``, which names that card and its power
limit), never with a TPU figure, and is null on another card or power
limit.  A row that fails, raises or overruns its time limit is an error; a
row is skipped only before it starts, for want of wall budget, and is then
listed under ``skipped``.  Every error and accuracy violation is collected,
and the script exits nonzero after all rows have printed.  It writes no file
but ``--out``.

The default device is the GPU; without one the script stops at once unless
``--device cpu`` asks for the CPU, where every kernel runs its plain PyTorch
version (``kernel_smoke`` then reports ``route: "plain"``).  ``--n N`` runs
every row at N points instead of its own n and records ``reduced_from``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SENTINEL = "##TORCH_BENCH_ROW## "
HEADLINE_ROW = "matvec_n10000"
ROW_TIMEOUT_S = 600
BUDGET_S = 1800
KERNEL_DIR_ENV = "HTOOL_TPU_TORCH_KERNEL_DIR"  # read by htool_tpu_torch.kernels

# each row's nominal n, in bench.py's _row_names order; blr_n10000 runs
# only with --flat-blr, as BENCH_FLAT_BLR=1 makes it run in bench.py
NOMINAL_N = {
    "kernel_smoke": None,
    "matvec_n10000": 10_000,
    "ddm_n100000": 100_000,
    "ddm2_n20000": 20_000,
    "blr2_n10000": 10_000,
    "matvec_n100000": 100_000,
    "complex_matvec_n100000": 100_000,
    "blr_n10000": 10_000,
    "weak_scaling_static": 10_000,
    "assembly_cold_n10000": 10_000,
    "blr2_n100000": 100_000,
}

# wall seconds a row may take on the card, its process start and the kernel
# build included (about 1.5 times the first full run's, NVIDIA H100 80GB
# HBM3 at 700 W: 8 - 44 s a row); a row starts only with 1.15 times this left
ESTIMATE_S = {
    "kernel_smoke": 60, "matvec_n10000": 20, "ddm_n100000": 25, "ddm2_n20000": 25,
    "blr2_n10000": 25, "matvec_n100000": 30, "complex_matvec_n100000": 30,
    "blr_n10000": 30, "weak_scaling_static": 20, "assembly_cold_n10000": 60,
    "blr2_n100000": 70,
}

# bench.py's iteration labels: (row, key of the row's result)
ITERATION_LABELS = {
    "ras_gmres_1level": ("ddm_n100000", "iterations"),
    "ras_gmres_1level_20k": ("ddm2_n20000", "iterations_one_level"),
    "ras_geneo_additive_2level_20k": ("ddm2_n20000", "iterations_two_level"),
}


# ---------------------------------------------------------------------------
# the rows (each runs in its own process)
# ---------------------------------------------------------------------------

class Row:
    """What a row's function gets: the device, its n, the violations."""

    def __init__(self, name: str, device, n_override):
        self.name = name
        self.device = device
        self.nominal = NOMINAL_N[name]
        self.n = self.nominal if n_override is None else n_override
        self.violations: list = []

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, fn):
        """(fn(), seconds), the device synchronized on both sides."""
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0

    def result(self, **fields) -> dict:
        if self.nominal is not None and self.n != self.nominal:
            fields["reduced_from"] = self.nominal
        return fields

    def sphere(self):
        """The row's points on the sphere (host, float64), the same points
        on the device in float32, and the Laplace generator over them."""
        import torch

        import htool_tpu_torch as ht
        from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

        pts = create_sphere(self.n)
        pts_d = torch.as_tensor(pts.astype(np.float32), device=self.device)
        return pts, pts_d, ht.KernelGenerator(laplace_kernel_symmetric, pts_d, pts_d)

    def partitioned_tree(self, pts, P: int):
        """A tree of leaf 256 with P partitions.  A tree whose leaves are
        fewer than P repeats points across its partitions (in both packages),
        and the Schwarz solve on it is wrong; so at a reduced n, P is halved
        until the partitions hold every point once.  (tree, P)"""
        import htool_tpu_torch as ht

        while True:
            tree = ht.build_cluster_tree(pts, max_leaf_size=256, n_partitions=P)
            if int(tree.partition_offsets_sizes()[1].sum()) == len(pts):
                return tree, P
            if self.n == self.nominal or P == 1:
                raise RuntimeError(f"{self.name}: the {P} partitions do not cover the points")
            P //= 2


def _row_kernel_smoke(row: Row) -> dict:
    """bench.py:68-181: every product route on 8 blocks of 256², rank 8,
    k = 8, against a float64 NumPy oracle."""
    import torch

    import htool_tpu_torch as ht
    from htool_tpu_torch.ops.bucket_matvec import dense_bucket_matvec, lr_bucket_matvec
    from htool_tpu_torch.ops.tiled_matvec import (
        build_tile_plan,
        build_tile_plan_complex,
        build_tile_plan_lr_split,
        tiled_bucket_matvec,
    )

    dev = row.device
    rng = np.random.RandomState(0)
    n = 2048
    nb, bm, bn, r = 8, 256, 256, 8
    L = n + 64
    offs = np.arange(nb, dtype=np.int64) * 256
    szs = np.full(nb, bm, np.int64)
    data = rng.randn(nb, bm, bn).astype(np.float32)
    U = rng.randn(nb, bm, r).astype(np.float32)
    V = rng.randn(nb, r, bn).astype(np.float32)
    x = rng.randn(L, 8).astype(np.float32)
    zdata = (data + 1j * rng.randn(nb, bm, bn)).astype(np.complex64)
    xz = (x + 1j * rng.randn(L, 8)).astype(np.complex64)

    def t(a):
        return torch.as_tensor(a, device=dev)

    off_t = t(offs)

    def oracle(mats, xin, trans=False):
        y = np.zeros(xin.shape, np.complex128 if xin.dtype.kind == "c" else np.float64)
        for i in range(nb):
            blk = (mats[i].T if trans else mats[i]).astype(y.dtype)
            y[offs[i]: offs[i] + blk.shape[0]] += blk @ xin[offs[i]: offs[i] + blk.shape[1]]
        return y

    def dense(d):
        return ht.DenseBucket(data=t(d), t_off=off_t, s_off=off_t, t_sizes=szs, s_sizes=szs)

    lr = ht.LowRankBucket(U=t(U), V=t(V), t_off=off_t, s_off=off_t, t_sizes=szs, s_sizes=szs,
                          ranks=np.full(nb, r, np.int64))
    lr_ref = oracle([U[i] @ V[i] for i in range(nb)], x)
    routes = {
        "dense_tiled": (tiled_bucket_matvec, lambda: tiled_bucket_matvec(
            build_tile_plan(dense(data), "t", L), t(x)), lambda: oracle(data, x)),
        "dense_tiled_trans": (tiled_bucket_matvec, lambda: tiled_bucket_matvec(
            build_tile_plan(dense(data), "s", L), t(x)), lambda: oracle(data, x, trans=True)),
        "lr_split_tiled": (tiled_bucket_matvec, lambda: tiled_bucket_matvec(
            build_tile_plan_lr_split(lr, "t", L), t(x)), lambda: lr_ref),
        "complex_tiled": (tiled_bucket_matvec, lambda: tiled_bucket_matvec(
            build_tile_plan_complex(dense(zdata), "t", L), t(xz)), lambda: oracle(zdata, xz)),
        "dense_unplanned": (dense_bucket_matvec, lambda: dense_bucket_matvec(
            t(data), off_t, off_t, t(x), False, L), lambda: oracle(data, x)),
        "lr_unplanned": (lr_bucket_matvec, lambda: lr_bucket_matvec(
            t(U), t(V), off_t, off_t, t(x), False, L), lambda: lr_ref),
    }
    results = {}
    for name, (wrapper, run, want) in routes.items():
        try:
            before = wrapper.launches
            t0 = time.perf_counter()
            got = run()
            row.sync()
            wall = time.perf_counter() - t0
            ref = want()
            err = float(np.linalg.norm(got.cpu().numpy() - ref)
                        / max(np.linalg.norm(ref), 1e-30))
            launches = wrapper.launches - before
            on_card = dev.type == "cuda"
            ok = err < 1e-4 and (launches > 0 or not on_card)
            results[name] = dict(ok=ok, rel_err=err, wall_s=wall, launches=launches,
                                 route="cuda" if on_card else "plain")
            if not ok:
                row.violations.append(f"kernel_smoke:{name}: rel_err {err:.3e}, "
                                      f"{launches} launches")
        except Exception as e:  # noqa: BLE001 - each route reports its own failure
            traceback.print_exc()
            results[name] = dict(ok=False, error=repr(e)[:200])
            row.violations.append(f"kernel_smoke:{name}: {repr(e)[:100]}")
    return results


def _row_matvec(row: Row, complex_: bool = False, nrhs: int = 8, eps: float = 1e-3) -> dict:
    """bench.py:184-262 (real) and :265-332 (complex64): assembly, tiled
    plans, 20 products at k = 8, the rel error on 256 generator rows."""
    import torch

    import htool_tpu_torch as ht
    from htool_tpu_torch.hmatrix.linalg import matvec, matvec_user, prepare_tiled_matvec
    from htool_tpu_torch.testing import laplace_kernel_complex_symmetric

    dev, n = row.device, row.n
    pts, pts_d, gen = row.sphere()
    if complex_:
        gen = ht.KernelGenerator(laplace_kernel_complex_symmetric, pts_d, pts_d)
    tree = ht.build_cluster_tree(pts, max_leaf_size=256)
    H, t_assembly = row.timed(lambda: ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0))
    info = ht.hmatrix_info(H)
    _, t_assembly_warm = row.timed(lambda: ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0))
    _, t_prepare = row.timed(lambda: prepare_tiled_matvec(H))

    rng = np.random.RandomState(0)
    xh = rng.randn(n, nrhs)
    if complex_:
        xh = (xh + 1j * rng.randn(n, nrhs)).astype(np.complex64)
    xc = torch.as_tensor(xh.astype(np.complex64 if complex_ else np.float32), device=dev)
    matvec(H, xc)
    iters = 20
    _, t_all = row.timed(lambda: [matvec(H, xc) for _ in range(iters)])
    t_mv = t_all / iters

    generated = float(n) * n / info["compression_ratio"]
    entries_per_s = generated * nrhs / t_mv
    wide = torch.complex128 if complex_ else torch.float64
    yu = matvec_user(H, xc).to(wide)
    sub = torch.as_tensor(rng.choice(n, min(256, n), replace=False), device=dev)
    A_rows = gen.block(sub, torch.arange(n, device=dev)).to(wide)
    y_ref = A_rows @ xc.to(wide)
    rel = float(torch.linalg.norm(yu[sub] - y_ref) / torch.linalg.norm(y_ref))
    if not rel < eps:
        row.violations.append(f"{row.name}: rel_error {rel:.3e} >= eps {eps:g}")
    out = dict(n=n, nrhs=nrhs, epsilon=eps, assembly_s=t_assembly,
               assembly_warm_s=t_assembly_warm, tiled_prepare_s=t_prepare, matvec_s=t_mv,
               compression_ratio=info["compression_ratio"], matvec_rel_error=rel,
               accuracy_ok=bool(rel < eps), compressed_entries_per_s=entries_per_s,
               effective_gbytes_per_s=entries_per_s * (8 if complex_ else 4) / 1e9)
    if not complex_:
        out.update(block_tree_plan_s=info.get("block_tree_walltime", 0.0),
                   rank_mean=info["rank_mean"], n_false_positive=info["n_false_positive"])
    return row.result(**out)


def _row_blr(row: Row, eps: float = 1e-4) -> dict:
    """bench.py:581-615: flat BLR build (block 512), LU with the error
    estimate, 10 solves of 8 right-hand sides."""
    import torch

    import htool_tpu_torch as ht

    pts, _, gen = row.sphere()
    tree = ht.build_cluster_tree(pts, max_leaf_size=256)
    A, t_build = row.timed(lambda: ht.build_blr(gen, tree, epsilon=eps, eta=10.0,
                                                block_size=512))
    F, t_lu = row.timed(lambda: ht.blr_lu(A, error_estimate=True))
    b = torch.as_tensor(np.random.RandomState(1).randn(row.n, 8).astype(np.float32),
                        device=row.device)
    ht.blr_solve(F, b)
    _, t_all = row.timed(lambda: [ht.blr_solve(F, b) for _ in range(10)])
    bw = F.info.get("backward_error_est")
    _check_backward_error(row, bw, eps)
    return row.result(n=row.n, epsilon=eps, build_s=t_build, lu_s=t_lu, solve_s=t_all / 10,
                      backward_error_est=bw, n_rank_capped=F.info.get("n_rank_capped_cells"),
                      compression=A.compression_info()["compression_ratio"],
                      accuracy_ok=bool(bw is not None and bw < 100 * eps))


def _row_blr2(row: Row, eps: float = 1e-4) -> dict:
    """bench.py:335-381: two-level BLR build, LU with the error estimate,
    10 solves of 8 right-hand sides."""
    import torch

    import htool_tpu_torch as ht

    pts, _, gen = row.sphere()
    tree = ht.build_cluster_tree(pts, max_leaf_size=256)
    # at a reduced n the default panel (4,096 rows at least) would leave one
    # panel; a third of n gives the four panels of the nominal 10,000
    coarse = None if row.n == row.nominal else max(128, row.n // 3)
    A, t_build = row.timed(lambda: ht.build_blr2(gen, tree, epsilon=eps, coarse_size=coarse))
    F, t_lu = row.timed(lambda: ht.blr2_lu(A, error_estimate=True))
    b = torch.as_tensor(np.random.RandomState(1).randn(row.n, 8).astype(np.float32),
                        device=row.device)
    ht.blr2_solve(F, b)
    _, t_all = row.timed(lambda: [ht.blr2_solve(F, b) for _ in range(10)])
    bw = F.info.get("backward_error_est")
    _check_backward_error(row, bw, eps)
    return row.result(
        n=row.n, epsilon=eps, build_s=t_build, build_aca_s=A.info.get("offdiag_aca_walltime"),
        build_diag_s=A.info.get("diag_build_walltime"), lu_s=t_lu, solve_s=t_all / 10,
        backward_error_est=bw, n_rank_capped=F.info.get("n_rank_capped_pairs"),
        diag_mode=A.diag_mode, n_levels=A.info.get("n_levels", 2), n_panels=A.nC,
        factor_bytes=F.memory_bytes(), accuracy_ok=bool(bw is not None and bw < 100 * eps))


def _check_backward_error(row: Row, bw, eps: float) -> None:
    if bw is None or not bw < 100 * eps:
        row.violations.append(f"{row.name}: backward_error {bw} >= 100*eps")


def _solve_timed(row: Row, solver, b, tol: float):
    """Two solves (cold, warm) of GMRES(60) to ``tol``: (x, infos, seconds
    of each)."""
    secs = []
    for _ in range(2):
        (x, infos), dt = row.timed(lambda: solver.solve(b, tol=tol, krylov="gmres", restart=60,
                                                        maxiter=200))
        secs.append(dt)
    return x, infos, secs


def _residual(H, x, b) -> float:
    import torch

    return float(torch.linalg.norm(H @ x - b) / torch.linalg.norm(b))


def _row_ddm(row: Row, P: int = 64, eps: float = 1e-3, tol: float = 1e-6) -> dict:
    """bench.py:384-446: the flagship, one-level RAS with dense local
    solves and GMRES(60)."""
    import torch

    import htool_tpu_torch as ht
    from htool_tpu_torch.hmatrix.linalg import prepare_tiled_matvec
    from htool_tpu_torch.solvers import DDMSolver

    pts, _, gen = row.sphere()
    tree, P = row.partitioned_tree(pts, P)
    H, t_assembly = row.timed(lambda: ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0))
    prepare_tiled_matvec(H)
    solver, t_facto = row.timed(lambda: DDMSolver(H, gen, tree, schwarz="ras",
                                                  overlap_radius=0.02, local_solver="dense"))
    x_true = torch.as_tensor(np.random.RandomState(0).randn(row.n).astype(np.float32),
                             device=row.device)
    b = H @ x_true  # through the compressed operator: the oracle stays consistent in f32
    x, infos, (t_solve, t_solve_warm) = _solve_timed(row, solver, b, tol)
    res = _residual(H, x, b)
    if not res < 10 * tol:
        row.violations.append(f"{row.name}: residual {res:.3e} >= 10*tol")
    return row.result(n=row.n, subdomains=P, epsilon=eps, tol=tol, assembly_s=t_assembly,
                      facto_one_level_s=t_facto, solve_s=t_solve, solve_warm_s=t_solve_warm,
                      iterations=infos.get("Nb_it"), residual=res,
                      converged=bool(res < 10 * tol))


def _row_ddm2(row: Row, P: int = 8, eps: float = 1e-3, tol: float = 1e-6) -> dict:
    """bench.py:449-528: GenEO (ν = 2, local store) with the additive
    correction beside one level."""
    import torch

    import htool_tpu_torch as ht
    from htool_tpu_torch.hmatrix.linalg import matvec, prepare_tiled_matvec
    from htool_tpu_torch.solvers import DDMSolver, build_geneo_coarse_space, build_geometric_overlap

    pts, _, gen = row.sphere()
    tree, P = row.partitioned_tree(pts, P)
    H, t_assembly = row.timed(lambda: ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0))
    prepare_tiled_matvec(H)
    overlap = build_geometric_overlap(tree, 0.05)
    infos = {}
    coarse, t_coarse = row.timed(lambda: build_geneo_coarse_space(
        gen, tree, overlap, lambda v: matvec(H, v, op="N"), nu=2, symmetry="S",
        store="local", infos=infos))
    solver, t_facto = row.timed(lambda: DDMSolver(
        H, gen, tree, schwarz="ras", overlap=overlap, coarse=coarse,
        coarse_correction="additive", local_solver="dense"))
    x_true = torch.as_tensor(np.random.RandomState(0).randn(row.n).astype(np.float32),
                             device=row.device)
    b = H @ x_true
    solver1 = DDMSolver(H, gen, tree, schwarz="ras", overlap=overlap, local_solver="dense")
    _, infos1 = solver1.solve(b, tol=tol, krylov="gmres", restart=60, maxiter=200)
    x, infos2, (t_solve, t_solve_warm) = _solve_timed(row, solver, b, tol)
    res = _residual(H, x, b)
    if not res < 10 * tol:
        row.violations.append(f"{row.name}: residual {res:.3e} >= 10*tol")
    return row.result(
        n=row.n, subdomains=P, tol=tol, assembly_s=t_assembly, coarse_space_s=t_coarse,
        geneo_evp_s=infos.get("GenEO_geev_walltime"),
        geneo_ztaz_s=infos.get("GenEO_ZtAZ_walltime"),
        coarse_size=infos.get("GenEO_coarse_space_size"), facto_one_level_s=t_facto,
        solve_s=t_solve, solve_warm_s=t_solve_warm,
        iterations_one_level=infos1.get("Nb_it"), iterations_two_level=infos2.get("Nb_it"),
        residual=res, converged=bool(res < 10 * tol))


def _row_weak_scaling_static(row: Row, eps: float = 1e-3) -> dict:
    """bench.py:531-578: from the H-matrix of each partition plan, the
    stored entries of each partition's block row, their balance, and the
    bytes the collectives of one product move, for P = 1, 2, 4, 8."""
    import htool_tpu_torch as ht
    from htool_tpu_torch import native

    n, itemsize = row.n, 4
    pts, _, gen = row.sphere()
    per_P = {}
    for P in (1, 2, 4, 8):
        tree = ht.build_cluster_tree(pts, max_leaf_size=256, n_partitions=P)
        H = ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0)
        offs, szs = tree.partition_offsets_sizes()
        ends = np.asarray(offs, np.int64) + np.asarray(szs, np.int64)
        entries = np.zeros(P, np.int64)
        for b in H.dense_buckets + H.lr_buckets:
            own = np.searchsorted(ends, b.t_off.cpu().numpy(), side="right")
            bm, bn = b.block_shape
            per_block = bm * bn if isinstance(b, ht.DenseBucket) else b.rank_padded * (bm + bn)
            np.add.at(entries, own, per_block)
        comm_N = (n - n // P) * itemsize  # all_gather: bytes a partition receives
        comm_T = n * itemsize  # psum_scatter: bytes a partition reduces
        total = float(entries.sum())
        per_P[str(P)] = dict(
            per_device_entries_max=int(entries.max()),
            per_device_entries_mean=total / P,
            balance=float(entries.max() / (total / P)),
            flops_per_device_mean=float((entries * 2).mean()),
            collective_bytes_N=int(comm_N),
            collective_bytes_T=int(comm_T),
            comm_to_compute_bytes=float(comm_N / (entries.mean() * itemsize)),
        )
        del H
    return row.result(n=n, per_P=per_P,
                      tree_backend="native" if native.native_available() else "python")


def _row_assembly_cold(row: Row, eps: float = 1e-3) -> dict:
    """bench.py:618-658: the process's first assembly (the device was
    claimed before, so this is the first use of torch's kernels, cuBLAS,
    cuSOLVER and the allocator), a warm one, and the first product, which
    builds the kernel library into the empty directory the parent named."""
    import torch

    import htool_tpu_torch as ht
    from htool_tpu_torch import kernels
    from htool_tpu_torch.hmatrix.linalg import matvec, prepare_tiled_matvec

    pts, _, gen = row.sphere()
    tree = ht.build_cluster_tree(pts, max_leaf_size=256)
    H, t_cold = row.timed(lambda: ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0))
    _, t_warm = row.timed(lambda: ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0))
    prepare_tiled_matvec(H)
    x = torch.as_tensor(np.random.RandomState(0).randn(row.n, 8).astype(np.float32),
                        device=row.device)
    _, t_first = row.timed(lambda: matvec(H, x))
    return row.result(n=row.n, assembly_cold_s=t_cold, assembly_warm_s=t_warm,
                      kernel_build_s=t_first,
                      n_kernel_builds=int(bool(kernels.build_info.get("compiled"))),
                      kernel_build_dir=str(kernels._BUILD))


ROWS = {
    "kernel_smoke": _row_kernel_smoke,
    "matvec_n10000": _row_matvec,
    "ddm_n100000": _row_ddm,
    "ddm2_n20000": _row_ddm2,
    "blr2_n10000": _row_blr2,
    "matvec_n100000": _row_matvec,
    "complex_matvec_n100000": lambda row: _row_matvec(row, complex_=True),
    "blr_n10000": _row_blr,
    "weak_scaling_static": _row_weak_scaling_static,
    "assembly_cold_n10000": _row_assembly_cold,
    "blr2_n100000": _row_blr2,
}


def _device_line(device: str) -> dict:
    """The device a run measures: platform, name, count, and on the card
    ``nvidia-smi``'s name and power limit."""
    if device == "cpu":
        return dict(platform="cpu", kind="cpu", count=1)
    import torch

    device = torch.device(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=torch.cuda.device_count(), nvidia_smi=smi.stdout.strip())


def run_row(name: str, device: str, n) -> int:
    """Child entry: claim the device, run one row, print its result on the
    sentinel line; nonzero exit when the row raised."""
    import torch

    import htool_tpu_torch as ht

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.zeros((), device=dev)  # claim the device before any clock starts
        torch.cuda.synchronize(dev)
    ht.set_default_device(dev)
    row = Row(name, dev, n)
    aux, err = {}, None
    try:
        aux[name] = ROWS[name](row)
    except Exception as e:  # noqa: BLE001 - the row's failure is its result
        traceback.print_exc()
        err = repr(e)[:300]
    print(SENTINEL + json.dumps({"aux": aux, "violations": row.violations, "error": err}),
          flush=True)
    return 1 if err else 0


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

def _run_row_subprocess(name: str, device: str, n, timeout_s: float):
    """Run one row in its own process: (result fragment, violations,
    error or None).  A row that overruns ``timeout_s`` is killed and is an
    error."""
    cmd = [sys.executable, os.path.abspath(__file__), "--row", name, "--device", device]
    if n is not None:
        cmd += ["--n", str(n)]
    env = dict(os.environ)
    kernel_dir = None
    if name.startswith("assembly_cold"):  # the first product builds into an empty directory
        kernel_dir = tempfile.mkdtemp(prefix="torch_bench_kernels_")
        env[KERNEL_DIR_ENV] = kernel_dir
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s,
                              cwd=ROOT, env=env)
    except subprocess.TimeoutExpired as e:
        tail = (e.stderr or b"")[-2000:]
        sys.stderr.write(tail.decode(errors="replace") if isinstance(tail, bytes) else tail)
        return {}, [], f"row timed out after {timeout_s:.0f}s"
    finally:
        if kernel_dir:
            shutil.rmtree(kernel_dir, ignore_errors=True)
    payload = None
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith(SENTINEL):
            payload = json.loads(line[len(SENTINEL):])
            break
    if payload is None or payload["error"] is not None:
        sys.stderr.write(proc.stderr[-4000:])
    if payload is None:
        return {}, [], f"row produced no result (rc={proc.returncode})"
    return payload["aux"], payload["violations"], payload["error"]


def _load_baseline() -> dict:
    path = os.path.join(ROOT, "torch_bench_baseline.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _headline(value, device_line: dict, baseline: dict) -> str:
    """The headline line; ``vs_baseline`` only against the port's own
    first run on a card of the same name and power limit."""
    vs = None
    if value and baseline.get("value") and device_line.get("nvidia_smi") == baseline.get(
            "nvidia_smi"):
        vs = value / float(baseline["value"])
    return json.dumps({"metric": "hmatrix_matvec_compressed_entries_per_s", "value": value,
                       "unit": "entries/s", "vs_baseline": vs,
                       "device": device_line["kind"]})


def _collect_iterations(aux: dict, baseline: dict) -> None:
    """bench.py's iteration block, held against the port's recorded counts:
    a count above 1.5 times the recorded one is reported on stderr.  Rows
    run at a reduced n are not compared."""
    its = {}
    for label, (name, key) in ITERATION_LABELS.items():
        frag = aux.get(name)
        if isinstance(frag, dict) and frag.get(key) is not None:
            its[label] = frag[key]
            old = baseline.get("iterations", {}).get(label)
            if old and "reduced_from" not in frag and frag[key] > 1.5 * old:
                print(f"[torch_bench] ITERATION REGRESSION {label}: {frag[key]} against the "
                      f"recorded {old}", file=sys.stderr)
    if its:
        aux["iterations"] = its


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default=None,
                    help="comma-separated rows to run (default: all but blr_n10000)")
    ap.add_argument("--flat-blr", action="store_true", help="also run blr_n10000")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=None,
                    help="run every row at this n instead of its own")
    ap.add_argument("--out", help="file for the cumulative results",
                    default=os.path.join(ROOT, "torch_bench_out", "torch_bench_aux.json"))
    ap.add_argument("--row", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.row is not None:
        return run_row(args.row, args.device, args.n)

    if args.device != "cpu":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch_bench: no CUDA device; pass --device cpu to run the "
                             "plain versions on the CPU")
    if args.rows:
        wanted = args.rows.split(",")
        unknown = sorted(set(wanted) - set(ROWS))
        if unknown:
            raise SystemExit(f"torch_bench: unknown rows {unknown}; rows are {list(ROWS)}")
        names = [r for r in ROWS if r in wanted]
    else:
        names = [r for r in ROWS if r != "blr_n10000" or args.flat_blr]

    t_start = time.perf_counter()
    device_line = _device_line(args.device)
    baseline = _load_baseline()
    aux: dict = {"device": device_line, "rows": names, "skipped": {}, "row_wall_s": {}}
    violations: list = []
    headline = None
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for name in names:
        remaining = BUDGET_S - (time.perf_counter() - t_start)
        if remaining < 1.15 * ESTIMATE_S[name]:
            aux["skipped"][name] = f"budget: {remaining:.0f} s left < 1.15 x {ESTIMATE_S[name]} s"
            print(f"[torch_bench] SKIP {name}: {aux['skipped'][name]}", file=sys.stderr)
            continue
        t0 = time.perf_counter()
        frag, row_violations, err = _run_row_subprocess(
            name, args.device, args.n, min(ROW_TIMEOUT_S, remaining))
        aux["row_wall_s"][name] = time.perf_counter() - t0
        if err is not None:
            aux[name] = {"error": err}
            violations.append(f"{name}: {err[:150]}")
        else:
            aux.update(frag)
        violations.extend(row_violations)
        if name == HEADLINE_ROW and err is None:
            headline = aux[name]["compressed_entries_per_s"]
        print(f"[torch_bench] {name}: {aux['row_wall_s'][name]:.1f} s", file=sys.stderr)
        _collect_iterations(aux, baseline)
        aux["violations"] = violations
        # stream: the cumulative results to stderr and --out, a fresh headline
        print(json.dumps(aux), file=sys.stderr)
        with open(args.out, "w") as f:
            json.dump(aux, f, indent=1)
        print(_headline(headline, device_line, baseline), flush=True)
        sys.stderr.flush()

    if HEADLINE_ROW in names and headline is None:
        violations.append("headline row matvec_n10000 produced no result")
    aux["violations"] = violations
    aux["wall_s"] = time.perf_counter() - t_start
    with open(args.out, "w") as f:
        json.dump(aux, f, indent=1)
    print(json.dumps(aux), file=sys.stderr)
    print(_headline(headline, device_line, baseline), flush=True)
    if violations:
        print("TORCH_BENCH VIOLATIONS: " + "; ".join(violations), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
