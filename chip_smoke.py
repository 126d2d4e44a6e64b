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
   (n = 2,000; with plans attached, every low-rank bucket on its split
   two-stage plan, held against the unplanned product);
3. main path — sphere → cluster tree and block plan from the native C++
   planner (the default; the library must build, and both must come from
   it) → H-matrix (f32, Laplace kernel, leaf
   256, ε = 1e-3, η = 10) → tiled plans → one-level RAS (64 subdomains,
   overlap 0.02, dense local solves) → restarted GMRES(60) to 1e-6, twice,
   then once more with a float64 NumPy right-hand side (GMRES in float64,
   every product still through the kernel); GMRES must take the reference's
   3 iterations; the matvec at k = 8 is timed
   with the kernel and with its plain version, and checked against
   generator rows; assembly and the Schwarz set-up are timed again warm;
3b. native planner — the flagship's tree and block plan from the native
   planner (``"auto"``) and from the NumPy builders (``"python"``) on the
   same points, timed; the native calls are counted and the two block plans
   must have the same leaves;
4. kernel vs plain — every bucket term of that H-matrix, both
   orientations, k = 1 and 8, f32 and f64, against the plain PyTorch
   version on the same CUDA tensors; every low-rank bucket through its
   split two-stage plan, timed;
5. kernel edges — the same comparison on random buckets with shapes the
   flagship does not reach: ranks above 64, non-square and 6272-wide
   blocks, odd widths with rank 99 (no 16-byte alignment: the element-wise
   copy path), rank 1, a bucket of one 6272 x 6272 block, k = 1, 2, 3, 5, 8
   and 11;
5b. pair kernel vs plain — the same shapes as mirror buckets of a square
   operator, f32, f64, c64 and c128, k = 1, 2, 3, 5, 8 and 11, each
   conjugation: the pair launch (a block and its mirror in one launch)
   against its plain version and against the two per-term kernels; a
   shape the pass does not take (a rank too wide for a cluster of 8 CTAs)
   is listed, and must keep per-term plans;
5c. the pair pass at the cells' shapes — the stream cells' operators (the
   100k sphere, leaf 100, eta 100, eps 1e-3, 'S', 'L') in float32 and
   complex64: one planned product at k = 1 and at k = 8 launches the pair
   kernel once a mirror bucket and the per-term kernel once for each other
   bucket (the pair row's main-path launches); each mirror bucket's pair
   plan against its plain version and against its two per-term plans at
   k = 1 and 8, with the pair launch's, the two per-term launches' and the
   plain version's times;
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
   cores at k = 8; every low-rank term through the two-stage kernel), and the random buckets of phase 5's edge shapes with
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
    costs, on the host clock over 1,000 calls and between CUDA events;
16. two-level path — the JAX bench's ``ddm2_n20000`` row: sphere n = 20,000,
    f32, leaf 256, 8 subdomains, ε = 1e-3, tiled plans, overlap 0.05, GenEO
    (ν = 2, ``symmetry="S"``, local store) with the additive correction, RAS
    with dense local solves, GMRES(60) to 1e-6 cold and warm, beside the
    one-level solve; the GenEO infos; Q r of the local store against a
    replicated build (≤ 1e-4); true residuals < 10·tol; every product through
    the planned kernel (the E = Z* A Z product at k = 16), none through a plain
    version; that wide product held against its plain version; a profiler
    window over one GenEO build;
17. two-level grid — the 7-point grid Laplacian on 32³ points (n = 32,768,
    float64, the matrix filled on the card), ``MatrixGenerator``,
    leaf 64, 64 subdomains, ε = 1e-8, overlap radius 1.5, GenEO ν = 8, local
    store; one-level RAS and the additive, deflated and balanced corrections
    through GMRES(60) to 1e-6: every residual < 10·tol, the fewest two-level
    iterations strictly below the one-level count, coarse size = Σ νᵢ; the E
    product at k = 512 held against its plain version (≤ 1e-12);
18. grid Cholesky — ``cholesky_factorization(method="blr")`` of phase 17's
    H-matrix (f64, block 256, ε = 1e-8) and ``cholesky_solve`` on 2
    right-hand sides: residual against the matrix < 1e-6;
19, 20. two-level BLR — the JAX bench's ``blr2_n10000`` and ``blr2_n100000``
    rows (bench.py:335-381: sphere, f32, leaf 256, ε = 1e-4, ``build_blr2``
    defaults, so a dense diagonal at 10,000 and a nested one, three levels,
    at 100,000): build, ``blr2_lu`` with the error estimate (cold) and again
    (warm), 10 solves of 8 right-hand sides; the bench's keys, the warm LU's
    model rate (``blr2_lu_flops``), a profiler window over a warm LU, the
    peak memory; backward error < 100·ε and the residual on 256 generator
    rows < 10·ε;
21. flat BLR on the sphere — ``lu_factorization(method="blr")`` and
    ``lu_solve`` on cell 6's H-matrix (n = 20,000, f32), residuals against
    the H-matrix (< 10·1e-4) and on 256 generator rows (< 10·ε); the
    unfactorized BLR matrix back as an HMatrix (``blr_to_hmatrix``) and
    applied at k = 8 through the unplanned dense and low-rank kernels (one
    launch each, no plain version called), against the BLR product and the
    plain versions (≤ 1e-5);
22. the flagship with ``local_solver="blr"`` (ε = 1e-4, block 256) beside
    dense local solves: iterations within 2, true residual < 10·tol, set-up
    cold and warm, local-factor bytes against the dense inverses';
23. cell 6 with ``local_solver="blr2"`` and ``blr_coarse_size=1024``: every
    subdomain must take the two-level format; iterations within 2 of phase
    16's one-level dense count, residual < 10·tol;
24. distributed operator — the flagship operator on phase 7's tree,
    row-partitioned over P = 8 partitions that all live on this card
    (``build_distributed_hmatrix``, and phase 7's symmetric "S"/"L" block rows
    wired by ``build_distributed_from_local_hmatrices``), cold and warm: g2g
    N and T and l2l N at k = 1 and 8 through the unplanned kernels, each
    bucket term one launch over the blocks of all 8 partitions (the products
    within 1e-5 of the global H-matrix's on the same tree and within ε of
    256 generator rows; every bucket tensor on the card; launches of both
    unplanned kernels, no plain version; the launches of one product must
    equal its bucket terms, printed beside the 8 × terms of the
    per-partition route and the terms that take two stages), then
    ``DistributedDDMSolver`` (RAS, overlap 0.02, dense local LU) + GMRES(60)
    to 1e-6 cold and warm, beside the replicated ``DDMSolver`` on the same
    operator: the same iteration count, true residuals < 10·tol; the halo's
    colours, ``H_max`` and ``n_ext_max``, a profiler window over the warm
    solve (busy time, idle share, and the product kernels' and triangular
    solves' shares of the busy time), the peak memory, and the largest
    tensors still allocated when the phase starts;
25. the process-group route — ``initialize_multihost`` over NCCL at world
    size 1 (a file store in a temporary directory), phase 24's operator
    rebuilt on ``global_mesh``: the backend must read ``nccl``, the g2g
    products at k = 8 and the RAS solution equal phase 24's to 1e-6 and the
    solve takes phase 24's iteration count; the group is destroyed at the end;
26. cell 6 distributed — sphere n = 20,000, 8 partitions, overlap 0.05,
    GenEO ν = 2 on the distributed operator, in float32 and again in
    float64: the two-level additive solve on the partition slices with the
    replicated and with the local store beside the replicated two-level
    solver (the counts must be equal in float64; in float32 the local LU and
    the explicit inverses differ by rounding and the counts are reported);
    one level with BLR local solves (ε 1e-4, block 256, float32) within 2
    iterations of dense local solves, its solve time beside the dense one;
    every residual < 10·tol; one application of the stacked BLR local solve
    (the 8 subdomains' factors padded to one shape, one sweep of batched
    steps) against each subdomain's ``blr_solve``: ≤ 1e-5 in float32, ≤ 1e-12
    in float64 on the same float32 factors, both timed;
27. the port's bench rows — ``torch_bench.py --rows
    kernel_smoke,matvec_n10000,weak_scaling_static`` in a subprocess with a
    time limit: it must exit 0 with no violation and nothing skipped, and
    every ``kernel_smoke`` route must have launched its CUDA entry point; its
    headline line is printed as it gives it;
28. several processes — ``torch_multichip.py`` on phase 24's configuration
    (P = 8) twice: 2 gloo ranks sharing this card, then one NCCL rank a card
    on ``min(4, device_count)`` cards; each rank builds and holds only its
    partitions.  The gathered g2g products at k = 8 must be within 1e-6 of
    phase 24's operator on the same x, every rank must take the iteration
    count of phase 24's solver on the same right-hand side with a residual
    < 10·tol, launch both unplanned kernels and call no plain version, hold
    its tensors on its card (``cuda:{rank}`` under NCCL, shared under gloo),
    and the NCCL ranks' cards must be distinct; each rank's card, peak
    memory, product times and solve times are printed;
29. CG's step from CUDA graphs — ``cg_graphs_check`` at n = 20,000 in
    float32 and float64: the graph solve against the eager loop on one
    solver (equal iterations, x within 1e-5 and 1e-10 relative, equal CUDA
    launches and syncs a solve, one step replayed an iteration, an answer
    not changed by the next solve), each route's mean solve time.

Phase 24 also prints, on a line of its own, the memory still allocated when
it starts and the largest tensors.  The script's wall time is a line of
its own before the kernels line.

The ``kernels`` line before the last lists every entry point (three kernels
× float32, float64, complex64, complex128, the planned kernel's split
two-stage low-rank terms apart, and the pair kernel × float32 and
complex64, the dtypes of the cells that run it) with its launches on the
main paths (phases 3, 5c, 7, 11, 12, 16, 17 and 21 – 26; also split by k),
its time summed over the main path's terms at k = 8 (and, under ``k1``, at
k = 1) beside the plain version's, its bound (bytes moved once over
3.35 TB/s, a split term's staging tensor written and read once included,
a pair launch's live coefficients once, or operations over the peak rate
of the type, whichever is larger) and, as the library yardstick, ``torch.bmm`` on windows gathered
beforehand (gather and scatter excluded: no single PyTorch call computes a
bucket term).

Any failed check raises, so the script exits non-zero.  Only when every
phase passes does the last line read
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import warnings

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


def cg_graphs_check(n: int, dtype, device="cuda", seed: int = 0, reps: int = 20,
                    schwarz: str = "asm") -> dict:
    """CG with its step replayed from CUDA graphs against the eager loop, on
    one solver: the sphere's symmetric Laplace operator (leaf 100, ε 1e-3,
    η 100, tiled plans, ``dtype``), one-level ASM over 8 subdomains
    (overlap 0.05; ``schwarz="none"``: no preconditioner), CG to 1e-6.  The first solve captures (one
    ``krylov_graph_captures``); then the same right-hand side through the
    graphs and through the eager loop must take the same iterations, give x
    within 1e-5 (float32) or 1e-10 (float64) relative, make the same CUDA
    launches and syncs, and ``krylov_graph_steps`` must count the graph
    solve's iterations (none the eager one's); a later graph solve of
    another right-hand side leaves the first answer as it was.  Returns the
    readings, with each route's mean solve time over ``reps`` solves."""
    import torch

    import htool_tpu_torch as ht
    from htool_tpu_torch.hmatrix.linalg import prepare_tiled_matvec
    from htool_tpu_torch.ops.bucket_matvec import dense_bucket_matvec, lr_bucket_matvec
    from htool_tpu_torch.ops.pair_matvec import pair_bucket_matvec
    from htool_tpu_torch.ops.tiled_matvec import tiled_bucket_matvec
    from htool_tpu_torch.solvers import DDMSolver, ddm
    from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric
    from htool_tpu_torch.utils.profiling import counters

    dev = torch.device(device)
    pts = create_sphere(n, seed=seed)
    P = torch.as_tensor(pts, dtype=dtype, device=dev)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, P, P)
    tree = ht.build_cluster_tree(pts, max_leaf_size=100, n_partitions=8)
    H = ht.build_hmatrix(gen, tree, epsilon=1e-3, eta=100.0, symmetry="S", UPLO="L")
    prepare_tiled_matvec(H)
    solver = DDMSolver(H, gen, tree, schwarz=schwarz, overlap_radius=0.05)
    rng = np.random.RandomState(seed)
    b1, b2 = (torch.as_tensor(rng.randn(n), dtype=dtype, device=dev) for _ in range(2))

    def counts():
        c = counters()
        return dict(launches=tiled_bucket_matvec.cuda_launches + dense_bucket_matvec.cuda_launches
                    + lr_bucket_matvec.cuda_launches + pair_bucket_matvec.cuda_launches,
                    syncs=c.get("syncs", 0), pairs=c.get("product_pairs_fused", 0),
                    steps=c.get("krylov_graph_steps", 0),
                    captures=c.get("krylov_graph_captures", 0))

    def solve(b, graphs):
        devices = ddm._GRAPH_DEVICES
        ddm._GRAPH_DEVICES = devices if graphs else ()
        try:
            before = counts()
            x, infos = solver.solve(b, krylov="cg", tol=1e-6, maxiter=200)
            after = counts()
        finally:
            ddm._GRAPH_DEVICES = devices
        return x, infos, {k: after[k] - before[k] for k in after}

    def mean_ms(graphs):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            solve(b2, graphs)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / reps * 1e3

    _, _, first = solve(b1, True)
    x_g, inf_g, c_g = solve(b1, True)
    x_e, inf_e, c_e = solve(b1, False)
    kept = x_g.clone()
    x_2, inf_2, _ = solve(b2, True)
    rel = float(torch.linalg.norm(x_g - x_e) / torch.linalg.norm(x_e))
    out = dict(n=n, dtype=str(dtype).removeprefix("torch."), schwarz=schwarz,
               iterations_graph=inf_g["Nb_it"],
               iterations_eager=inf_e["Nb_it"], residual_graph=inf_g["Residual"],
               residual_eager=inf_e["Residual"], x_rel=rel, first_solve=first,
               graph_solve=c_g, eager_solve=c_e, answer_kept=bool(torch.equal(x_g, kept)),
               other_rhs_iterations=inf_2["Nb_it"],
               graph_ms=mean_ms(True), eager_ms=mean_ms(False))
    limit = 1e-5 if dtype in (torch.float32, torch.complex64) else 1e-10
    require(first["captures"] == 1 and c_g["captures"] == 0 and c_e["captures"] == 0,
            f"CG graphs: captures {first['captures']}, {c_g['captures']}, {c_e['captures']}")
    require(inf_g["Nb_it"] == inf_e["Nb_it"] and inf_g["Converged"] and inf_e["Converged"],
            f"CG graphs: {inf_g['Nb_it']} iterations through the graphs, {inf_e['Nb_it']} eager")
    require(rel <= limit, f"CG graphs: x {rel:.3e} from the eager solve's (limit {limit})")
    require(c_g["launches"] == c_e["launches"] > 0 and c_g["syncs"] == c_e["syncs"],
            f"CG graphs: launches and syncs {c_g} through the graphs, {c_e} eager")
    require(c_g["steps"] == inf_g["Nb_it"] and c_e["steps"] == 0,
            f"CG graphs: krylov_graph_steps {c_g['steps']} for {inf_g['Nb_it']} iterations, "
            f"{c_e['steps']} eager")
    require(out["answer_kept"], "CG graphs: a later solve changed an answer already returned")
    return out


def profile_window(name, fn, groups=None) -> dict:
    """Run fn under torch.profiler; device busy time is the union of the
    trace's kernel, memcpy and memset intervals, over the window's host
    wall time.  ``groups`` (name -> substrings of kernel names): the summed
    time of each group's kernels and its share of the busy time."""
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
    out = dict(window=name, wall_s=wall, device_busy_s=busy, idle_share=1 - busy / wall,
               n_device_events=len(dev),
               top_ms=[[n[:72], ms, count] for n, (ms, count) in top])
    for group, subs in (groups or {}).items():
        ms = sum(t for n, (t, _) in by_name.items() if any(x in n for x in subs))
        out[f"{group}_ms"] = ms
        out[f"{group}_share_of_busy"] = ms / 1e3 / busy
    return out


def blr2_lu_flops(A) -> float:
    """Model count of the floating-point operations that ``blr2_lu`` issues
    on ``A`` (a TwoLevelBLR with a dense or a nested diagonal), from its
    shapes: getrf 2/3·P³, trsm m·n² per triangular solve, 2mnk per product,
    and per recompression of c factor pairs [m, r]·[r, n] two QRs of each
    factor (geqrf + orgqr, 4mr² − 4/3·r³), the r×r product of the R factors,
    22r³ for its SVD and the two re-expansions.  Complex types count 4 real
    operations per real one."""
    import torch

    def qr(m, n):
        return 4 * m * n * n - 4 * n ** 3 / 3

    def recompress(c, m, n, r):
        return c * (qr(m, r) + qr(n, r) + 2 * r ** 3 + 22 * r ** 3 + 2 * m * r * r + 2 * r * r * n)

    def sweep(T, m):  # one triangular sweep of a dense-diagonal panel over m columns
        pairs = T.nC * (T.nC - 1) // 2
        return T.nC * T.P * T.P * m + pairs * 4 * T.R * T.P * m

    def model(T):
        nC, P, R = T.nC, T.P, T.R
        total = 0.0
        for K in range(nC):
            a = nC - K - 1
            if T.diag_mode == "dense":
                total += 2 * P ** 3 / 3
            else:
                sub = T.diag[K]
                if K > 0:  # the pending update, absorbed
                    total += sub.nC * 2 * sub.P * R * sub.P
                    total += recompress(sub.nC * (sub.nC - 1), sub.P, sub.P, sub.R + R)
                total += model(sub)
            if a == 0:
                break
            if T.diag_mode == "dense":
                total += 2 * a * R * P * P  # the column and the row panel
            else:
                total += 2 * sweep(T.diag[K], a * R)
            pairs = a * (a - 1)
            total += pairs * 4 * R * P * R + recompress(pairs, P, P, 2 * R)
            total += a * (4 * R * P * R + (2 * P * R * P if T.diag_mode == "dense" else 0))
            if T.diag_mode != "dense":
                total += recompress(a, P, P, 2 * R)
        return total

    return model(A) * (4 if A.dtype.is_complex else 1)


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
    t_start = time.perf_counter()

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
    import htool_tpu_torch.ops.pair_matvec as pair_ops
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
    from htool_tpu_torch.ops.pair_matvec import (
        build_pair_plan,
        pair_bucket_matvec,
        pair_bucket_matvec_reference,
    )
    from htool_tpu_torch.ops.tiled_matvec import (
        SplitPlan,
        build_tile_plan,
        build_tile_plan_lr_split,
        tiled_bucket_matvec,
        tiled_bucket_matvec_reference,
    )
    from htool_tpu_torch import native
    from htool_tpu_torch.solvers import DDMSolver, build_geneo_coarse_space, build_geometric_overlap
    from htool_tpu_torch.utils.profiling import counters
    from htool_tpu_torch.testing import (
        create_sphere,
        grid_laplacian,
        laplace_kernel_complex_symmetric,
        laplace_kernel_hermitian,
        laplace_kernel_symmetric,
    )

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    wrappers = (tiled_bucket_matvec, dense_bucket_matvec, lr_bucket_matvec, pair_bucket_matvec)
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
    # peak rates of the H100 SXM data sheet: 67 TFLOP/s float32 (no TF32: the
    # package pins full-precision matmuls) and 67 TFLOP/s float64 on the FP64
    # tensor cores, which the streaming kernels and cuBLAS both use; the
    # complex types run on the same units
    PEAK_FLOPS_S = {torch.float32: 67e12, torch.complex64: 67e12,
                    torch.float64: 67e12, torch.complex128: 67e12}
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
    # the same small operator with plans: every low-rank bucket, however
    # short, on its split plan (two CUDA launches a term)
    x0k = torch.as_tensor(np.random.RandomState(args.seed + 1).randn(2000, 8), device=dev)
    y0u = matvec(H0, x0k)
    prepare_tiled_matvec(H0)
    n_split0 = sum(isinstance(b.plan_t, SplitPlan) for b in H0.lr_buckets)
    n_terms0 = len(H0.dense_buckets) + len(H0.lr_buckets)
    reset_counts()
    y0p = matvec(H0, x0k)
    torch.cuda.synchronize()
    rel0 = float(torch.linalg.norm(y0p - y0u) / torch.linalg.norm(y0u))
    emit(dict(phase="small_planned_path", n=2000, dtype=str(H0.dtype), bucket_terms=n_terms0,
              split_plans=n_split0, launches=tiled_bucket_matvec.launches,
              cuda_launches=tiled_bucket_matvec.cuda_launches, planned_vs_unplanned_rel=rel0))
    require(n_split0 == len(H0.lr_buckets) > 0 and tiled_bucket_matvec.launches == n_terms0
            and tiled_bucket_matvec.cuda_launches == n_terms0 + n_split0,
            f"small planned path: {n_split0} split plans of {len(H0.lr_buckets)}, "
            f"{tiled_bucket_matvec.launches} terms launched of {n_terms0}, "
            f"{tiled_bucket_matvec.cuda_launches} CUDA launches")
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
    require(native.native_available(), "the native planner library did not build")
    native.ct_build_native.calls = native.bt_plan_native.calls = 0
    t0 = time.perf_counter()
    tree = ht.build_cluster_tree(pts, max_leaf_size=256, n_partitions=P)
    t_tree = time.perf_counter() - t0
    t0 = time.perf_counter()
    H = ht.build_hmatrix(gen, tree, epsilon=eps, eta=10.0)
    sync()
    t_asm = time.perf_counter() - t0
    native_calls = (native.ct_build_native.calls, native.bt_plan_native.calls)
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
        tree_s=t_tree, native_tree_builds=native_calls[0], native_block_plans=native_calls[1],
        assembly_s=t_asm, aca_s=H.info["aca_walltime"],
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
    require(n_split == len(H.lr_buckets),
            "prepare_tiled_matvec: a low-rank bucket has no split plan")
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
    require(native_calls == (1, 1),
            f"the main path's tree and block plan did not come from the native planner: "
            f"{native_calls} native calls")
    require(infos["Nb_it"] == ref_iters,
            f"GMRES took {infos['Nb_it']} iterations, the reference {ref_iters}")

    # ---------------- 3b. native planner ----------------
    # the flagship's tree and block plan from the C++ planner ("auto", as the
    # main path built them) and from the NumPy builders, on the same points
    planner = {}
    for backend in ("auto", "python"):
        c0, b0 = native.ct_build_native.calls, native.bt_plan_native.calls
        t0 = time.perf_counter()
        tree_b = ht.ClusterTreeBuilder(max_leaf_size=256, backend=backend).build(
            pts, n_partitions=P)
        t_tree_b = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan_b = ht.plan_block_tree(tree, epsilon=eps, eta=10.0, backend=backend)
        planner[backend] = dict(
            tree_s=t_tree_b, block_plan_s=time.perf_counter() - t0,
            native_calls=[native.ct_build_native.calls - c0, native.bt_plan_native.calls - b0],
            n_nodes=tree_b.n_nodes, n_dense=len(plan_b.dense),
            n_admissible=len(plan_b.admissible),
            same_permutation_as_main_path=bool(np.array_equal(tree_b.permutation,
                                                              tree.permutation)),
            leafset=sorted((l.t_off, l.t_size, l.s_off, l.s_size) for l in
                           plan_b.dense + plan_b.admissible))
    same_leaves = planner["auto"].pop("leafset") == planner["python"].pop("leafset")
    emit(dict(phase="native_planner", n=n, subdomains=P, library=native.get_lib()._name,
              same_block_plan=same_leaves, **planner))
    require(planner["auto"]["native_calls"] == [1, 1] and planner["python"]["native_calls"] == [0, 0]
            and planner["auto"]["same_permutation_as_main_path"],
            f"native planner: {planner}")
    require(same_leaves, "the native and the python block plans differ on the same tree")

    # ---------------- 4. kernel vs plain, per bucket term ----------------
    tol_rel = {torch.float32: 1e-5, torch.float64: 1e-12,
               torch.complex64: 1e-5, torch.complex128: 1e-12}
    m_pad = H.shape[0] + linalg._pad_in_of(H)
    rows, worst = [], {}

    def compare(plan, xp, what, conj=False, main=True):
        """Kernel vs plain version on the same CUDA tensors: the relative
        error; a main-path term's largest absolute error goes to its entry
        point's row."""
        yk = tiled_bucket_matvec(plan, xp, conj=conj)
        yr = tiled_bucket_matvec_reference(plan, xp, conj=conj)
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
        """The plan of a bucket term under the name of its route (a dense
        plan, or a low-rank bucket's split plan), and that name."""
        if isinstance(bucket, ht.DenseBucket):
            return {"dense": build_tile_plan(bucket, side, out_len)}, "dense"
        return {"split": build_tile_plan_lr_split(bucket, side, out_len)}, "split"

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
                for k in (1, 8):
                    xp = torch.randn((m_pad, k), dtype=dtype, device=dev)
                    for route, plan in routes.items():
                        key = (str(dtype), side, k, route)
                        rel = compare(plan, xp, f"bucket {bi} {key}", main=route == picked)
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
            # the loop's names would keep the last float64 copy alive to phase 13
            del bk, routes, plan
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
                    for conj in conjs:
                        for k in EDGE_KS:
                            xp = randn(L, k, dtype=dtype)
                            for route, plan in routes.items():
                                key = f"{dtype}/{side}/conj{int(conj)}/{route}/{bm}x{bn}r{r}"
                                worst_of[key] = max(worst_of.get(key, 0.0), compare(
                                    plan, xp, f"{key} k={k}", conj=conj, main=False))
                del bucket, routes
        return worst_of

    emit(dict(phase="kernel_edges", shapes=edge_shapes, ks=EDGE_KS,
              worst_rel=tiled_edges((torch.float32, torch.float64))))

    # ---------------- 5b. pair kernel vs plain ----------------
    # phase 5's shapes as mirror buckets of a square operator: the pair
    # launch against its plain version and against the two per-term kernels
    def pair_edges():
        worst_of, per_term = {}, []
        for bkind, (bm, bn, r, nb) in EDGE_SHAPES:
            for dtype in DTYPES:
                offs = dict(t_off=torch.randint(0, L - bm, (nb,), device=dev, generator=gen_r),
                            s_off=torch.randint(0, L - bn, (nb,), device=dev, generator=gen_r),
                            mirror=True)
                bucket = (ht.DenseBucket(data=randn(nb, bm, bn, dtype=dtype), **offs)
                          if bkind == "dense"
                          else ht.LowRankBucket(U=randn(nb, bm, r, dtype=dtype),
                                                V=randn(nb, r, bn, dtype=dtype), **offs))
                pair = build_pair_plan(bucket, L)
                shape = f"{bkind}/{bm}x{bn}r{r}/{dtype}"
                if pair is None:
                    per_term.append(shape)
                    continue
                terms = [routes_of(bucket, side, L)[0] for side in ("t", "s")]
                terms = [next(iter(t.values())) for t in terms]
                conjs = ((False, False), (True, False), (False, True)) if dtype.is_complex \
                    else ((False, False),)
                for cj_t, cj_s in conjs:
                    for k in EDGE_KS:
                        xp = randn(L, k, dtype=dtype)
                        yk = pair_bucket_matvec(pair, xp, conj_t=cj_t, conj_s=cj_s)
                        yr = pair_bucket_matvec_reference(pair, xp, None, cj_t, cj_s)
                        yt = tiled_bucket_matvec(terms[0], xp, conj=cj_t)
                        tiled_bucket_matvec(terms[1], xp, out=yt, conj=cj_s)
                        sync()
                        require(bool(torch.isfinite(yk).all()), f"pair {shape}: non-finite")
                        key = f"{shape}/conj{int(cj_t)}{int(cj_s)}"
                        for what, ref in (("plain", yr), ("per_term", yt)):
                            e = float(torch.linalg.norm(yk - ref) / torch.linalg.norm(ref))
                            require(e <= tol_rel[dtype], f"pair {key} k={k} vs {what}: {e:.3e}")
                            worst_of[f"{key}/{what}"] = max(worst_of.get(f"{key}/{what}", 0.0), e)
                del bucket, pair, terms
        return worst_of, per_term

    pair_worst, pair_per_term = pair_edges()
    emit(dict(phase="pair_kernel_vs_plain", shapes=edge_shapes, ks=EDGE_KS,
              worst_rel=pair_worst, per_term_shapes=pair_per_term))
    require(any("lr/6272x2080r96" in sh for sh in pair_per_term),
            "the rank-96 bucket should keep its per-term plans")

    # ---------------- 5c. the pair pass at the cells' shapes ----------------
    # the stream cells' operators (the benchmark's 100k sphere, leaf 100,
    # eta 100, eps 1e-3, 'S', 'L'), float32 and complex64: a planned product
    # at k = 1 and k = 8 with every count set to 0 before it (the pair row's
    # main-path launches), then each mirror bucket's pair plan against its
    # plain version and against the bucket's two per-term plans, timed into
    # the pair row: bytes are each live coefficient once (what the launch
    # fetches) and x and y once, operations 4 k (real) or 16 k (complex) a
    # live coefficient (each serves a row sum and a column sum)
    def account_pair(pair, bucket, x, ms, plain_ms):
        st = stat("pair_bucket_matvec", x.dtype)
        k, item = x.shape[1], x.element_size()
        if k == 1:
            st = st["k1"]
        st["terms"] += 1
        st["ms"] += ms
        st["plain_ms"] += plain_ms
        st["bytes"] += pair.streamed_bytes(k) + item * (x.numel() + pair.out_len * k)
        st["flops"] += (16 if x.dtype.is_complex else 4) * k * (pair.live // item)
        # the library yardstick: bmm on the blocks' windows of x gathered
        # beforehand, both terms
        dense = isinstance(bucket, ht.DenseBucket)
        A, Vb = (bucket.data, None) if dense else (bucket.U, bucket.V)
        R, C = bucket.block_shape
        xt = x[bucket.t_off.long()[:, None] + torch.arange(R, device=x.device)]
        xs = x[bucket.s_off.long()[:, None] + torch.arange(C, device=x.device)]

        def bmm():
            if Vb is None:
                torch.bmm(A, xs), torch.bmm(A.transpose(1, 2), xt)
            else:
                torch.bmm(A, torch.bmm(Vb, xs))
                torch.bmm(Vb.transpose(1, 2), torch.bmm(A.transpose(1, 2), xt))

        st["library_ms"] += event_ms(bmm)

    t_phase = time.perf_counter()
    pts_p = create_sphere(n, seed=args.seed)
    pts_pd = torch.as_tensor(pts_p.astype(np.float32), device=dev)
    tree_p = ht.build_cluster_tree(pts_p, max_leaf_size=100, n_partitions=64)
    pair_rows = []
    for kernel_p, cdt in ((laplace_kernel_symmetric, torch.float32),
                          (laplace_kernel_complex_symmetric, torch.complex64)):
        Hp = ht.build_hmatrix(ht.KernelGenerator(kernel_p, pts_pd, pts_pd), tree_p, epsilon=1e-3,
                              eta=100.0, symmetry="S", UPLO="L")
        require(Hp.dtype == cdt, f"the {cdt} cell's operator is {Hp.dtype}")
        prepare_tiled_matvec(Hp)
        mirror = [b for b in Hp.dense_buckets + Hp.lr_buckets if b.mirror]
        require(mirror and all(b.pair is not None and b.plan_t is None for b in mirror),
                f"{cdt}: a mirror bucket of the cell's operator has no pair plan")
        n_other = sum(1 for b in Hp.dense_buckets + Hp.lr_buckets if not b.mirror)
        m_pad_p = Hp.shape[0] + linalg._pad_in_of(Hp)
        for k in (1, 8):
            xk_p = torch.randn((n, k), dtype=cdt, device=dev)
            matvec(Hp, xk_p)  # warm
            sync()
            reset_counts()
            fused0 = counters().get("product_pairs_fused", 0)
            matvec(Hp, xk_p)
            sync()
            require(pair_bucket_matvec.launches == pair_bucket_matvec.cuda_launches == len(mirror)
                    and tiled_bucket_matvec.launches == n_other
                    and dense_bucket_matvec.launches == lr_bucket_matvec.launches == 0
                    and counters().get("product_pairs_fused", 0) - fused0 == len(mirror),
                    f"{cdt} k={k}: pair launches {pair_bucket_matvec.launches}, tiled "
                    f"{tiled_bucket_matvec.launches}, {len(mirror)} mirror buckets")
            collect_launches()
        for bi, bk_p in enumerate(mirror):
            pair = bk_p.pair
            build = (build_tile_plan if isinstance(bk_p, ht.DenseBucket)
                     else build_tile_plan_lr_split)
            per_t, per_s = build(bk_p, "t", m_pad_p), build(bk_p, "s", m_pad_p)
            for k in (1, 8):
                xp = torch.randn((m_pad_p, k), dtype=cdt, device=dev)
                yk = pair_bucket_matvec(pair, xp)
                yr = pair_bucket_matvec_reference(pair, xp)
                yt = tiled_bucket_matvec(per_t, xp)
                tiled_bucket_matvec(per_s, xp, out=yt)
                sync()
                require(bool(torch.isfinite(torch.view_as_real(yk) if cdt.is_complex else yk)
                             .all()), f"pair {cdt} bucket {bi} k={k}: non-finite")
                errs = {}
                for what, ref in (("plain", yr), ("per_term", yt)):
                    errs[what] = float(torch.linalg.norm(yk - ref) / torch.linalg.norm(ref))
                    require(errs[what] <= tol_rel[cdt],
                            f"pair {cdt} bucket {bi} k={k} vs {what}: {errs[what]:.3e}")
                st = stat("pair_bucket_matvec", cdt)
                st["max_abs_err"] = max(st["max_abs_err"], float((yk - yr).abs().max()))
                ms = event_ms(lambda: pair_bucket_matvec(pair, xp))
                plain_ms = event_ms(lambda: pair_bucket_matvec_reference(pair, xp))
                terms_ms = event_ms(lambda: tiled_bucket_matvec(
                    per_s, xp, out=tiled_bucket_matvec(per_t, xp)))
                account_pair(pair, bk_p, xp, ms, plain_ms)
                ints, _ = pair_ops._geometry(pair, pair_ops._kc(k))
                geom = dict(zip(pair_ops._GEOM, ints))
                pair_rows.append(dict(
                    dtype=str(cdt), k=k, kind=pair.kind, n_blocks=bk_p.n_blocks,
                    block_shape=bk_p.block_shape, rank=None if pair.kind == "dense" else pair.rank,
                    n_items=pair.n_items, cs=geom["cs"], G=geom["G"],
                    live_mb=pair.streamed_bytes(k) / 1e6, kernel_ms=ms, per_term_ms=terms_ms,
                    plain_ms=plain_ms, rel_vs_plain=errs["plain"],
                    rel_vs_per_term=errs["per_term"]))
            del per_t, per_s, xp, yk, yr, yt
        del Hp, mirror, bk_p, pair
        torch.cuda.empty_cache()
    emit(dict(phase="pair_main_path", n=n, rows=pair_rows,
              phase_s=time.perf_counter() - t_phase))
    del pts_pd, tree_p

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
                    h.t_root_off, bucket, in_side, out_side, is_mirror)
                yield bi, bucket, in_len, dict(
                    in_off=in_off, out_off=out_off, trans=mode in ("T", "C"),
                    conj=h.dtype.is_complex and mode in ("C", "conj"), out_len=out_len,
                    in_root=in_root, out_root=out_root)

    def run_term(fn, blocks, xp, kw):
        return fn(*blocks, kw["in_off"], kw["out_off"], xp, kw["trans"], kw["out_len"],
                  in_root=kw["in_root"], out_root=kw["out_root"], conj=kw.get("conj", False))

    def compare_term(kernel, plain, blocks, xp, kw, what, main=True):
        """Kernel vs plain version of one unplanned term: the relative error."""
        yr = run_term(plain, blocks, xp, kw)
        yk = run_term(kernel, blocks, xp, kw)
        sync()
        require(bool(torch.isfinite(yk).all()), f"non-finite kernel output {what}")
        r = float(torch.linalg.norm(yk - yr) / torch.linalg.norm(yr).clamp_min(1e-300))
        require(r <= tol_rel[xp.dtype], f"{what}: rel {r:.3e}")
        if main:
            st = stat(kernel.__name__, xp.dtype)
            st["max_abs_err"] = max(st["max_abs_err"], float((yk - yr).abs().max()))
        return r

    def time_term(kernel, plain, blocks, xp, kw):
        """(kernel ms, plain ms) of one unplanned term; at k = 8 and k = 1 the
        term is added to its entry point's sums."""
        tk = event_ms(lambda: run_term(kernel, blocks, xp, kw))
        tp = event_ms(lambda: run_term(plain, blocks, xp, kw))
        if xp.shape[1] in (1, 8):
            bm, bn = blocks[0].shape[1], blocks[-1].shape[2]
            account(kernel.__name__, blocks, xp, kw["out_len"], kw["in_off"] - kw["in_root"],
                    bm if kw["trans"] else bn, kw["trans"], kw.get("conj", False), tk, tp)
        return tk, tp

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
                            tk, tp = time_term(kernel, plain, blocks, xp, kw)
                            if dtype == torch.float32:
                                u_total[(bkind, k, "kernel")] += tk
                                u_total[(bkind, k, "plain")] += tp
                            u_rows.append(dict(
                                bucket=bi, kind=bkind, dtype=str(dtype), n_blocks=bucket.n_blocks,
                                block_shape=bucket.block_shape, mirror=bool(bucket.mirror),
                                rank=None if is_dense else bucket.rank_padded,
                                trans=bool(kw["trans"]), k=k, kernel_ms=tk, plain_ms=tp))
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
                      (bucket_ops, "lr_bucket_matvec_reference"),
                      (pair_ops, "pair_bucket_matvec_reference"))
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
                for conj in (False, True):
                    for k in (1, 8):
                        xp = crandn(m_pad_c, k, dtype=dtype)
                        for route, plan in routes.items():
                            key = f"tiled/{dtype}/{side}/conj{int(conj)}/k{k}/{route}"
                            c_worst[key] = max(c_worst.get(key, 0.0), compare(
                                plan, xp, f"bucket {bi} {key}", conj=conj,
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
            # the loop's names would keep the last complex128 copy (2.75 GB of
            # factors at n = 100,000) alive to the end of the script
            del bk, routes, plan
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
                            tk, tp = time_term(kernel, plain, blocks, xp, kw)
                            c_rows.append(dict(
                                path="hermitian_unplanned_path", kernel="unplanned",
                                dtype=str(dtype), bucket=bi,
                                kind="dense" if is_dense else "lr", n_blocks=bucket.n_blocks,
                                block_shape=bucket.block_shape, mirror=bool(bucket.mirror),
                                rank=None if is_dense else bucket.rank_padded,
                                trans=trans, conj=conj, k=k, kernel_ms=tk, plain_ms=tp))
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
        used = ("tiled_bucket_matvec", "pair_bucket_matvec") if planned else (
            "dense_bucket_matvec", "lr_bucket_matvec")
        # a pair plan applies a mirror bucket's two terms in one call
        calls = n_terms(HS) - (sum(b.pair is not None
                                   for b in HS.dense_buckets + HS.lr_buckets) if planned else 0)
        require(all(set(counts[w]) <= {torch.float32} for w in counts)
                and sum(sum(counts[w].values()) for w in used) == calls
                and sum(sum(c.values()) for c in counts.values()) == calls
                and plain_calls[0] == 0,
                f"real H on complex x (planned={planned}): launches {counts}, "
                f"plain calls {plain_calls[0]}")
        saved = {name: getattr(linalg, name) for name in counts}
        linalg.tiled_bucket_matvec = tiled_bucket_matvec_reference
        linalg.dense_bucket_matvec = dense_bucket_matvec_reference
        linalg.lr_bucket_matvec = lr_bucket_matvec_reference
        linalg.pair_bucket_matvec = pair_bucket_matvec_reference
        try:
            y_rc_plain = matvec_user(HS, xrc)
        finally:
            for name, fn in saved.items():
                setattr(linalg, name, fn)
        real_on_complex["planned" if planned else "unplanned"] = dict(
            rel_error=rel(y_rc[sub_t], ref_rc), kernel_vs_plain_rel=rel(y_rc, y_rc_plain))
        require(y_rc.dtype == torch.complex64, "real H on complex64 x: dtype")
    for b in HS.dense_buckets + HS.lr_buckets:
        b.plan_t = b.plan_s = b.pair = None
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
        "tiled_lr_split": lambda pl=build_tile_plan_lr_split(tiny_l, "t", 64):
            tiled_bucket_matvec(pl, x_t, out=y_t),
        "unplanned_dense": lambda: dense_bucket_matvec(
            tiny_d.data, tiny_d.s_off, tiny_d.t_off, x_t, False, 64, out=y_t),
        "unplanned_lr_two_stage": lambda: lr_bucket_matvec(
            tiny_l.U, tiny_l.V, tiny_l.s_off, tiny_l.t_off, x_t, False, 64, out=y_t),
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

    # ---------------- 16. two-level path: GenEO on the sphere ----------------
    # the JAX bench's two-level row (ddm2_n20000): RAS + GenEO (ν = 2, local
    # store, additive) + GMRES(60), beside the one-level solve
    del Hc, HH, gen_c, gen_h, buckets_c, buckets_h, bucket
    torch.cuda.empty_cache()
    GENEO_INFOS = ("GenEO_coarse_space_size", "GenEO_geev_walltime", "GenEO_ZtAZ_walltime",
                   "GenEO_facto_coarse_operator_walltime")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bench_iterations.json")) as f:
        ref_iters_2 = json.load(f)

    def planned_counts(h):
        """The wrappers' launches since the counts were set to 0: every
        product through the planned kernel, none through the unplanned ones
        or a plain version."""
        n_split_h = sum(isinstance(b.plan_t, SplitPlan) for b in h.lr_buckets)
        collect_split(n_split_h, n_terms(h))
        collect_launches()
        out = dict(products=matvec.products, launches=tiled_bucket_matvec.launches,
                   cuda_launches=tiled_bucket_matvec.cuda_launches,
                   launches_by_k={str(k): c for (_, k), c in
                                  sorted(tiled_bucket_matvec.launches_by_k.items())},
                   plain_version_calls=plain_calls[0])
        require(out["launches"] == n_terms(h) * out["products"] > 0
                and dense_bucket_matvec.launches == lr_bucket_matvec.launches == 0
                and out["plain_version_calls"] == 0,
                f"two-level path: launches {out}, unplanned "
                f"{dense_bucket_matvec.launches + lr_bucket_matvec.launches}")
        return out

    def wide_product(h, cs, dense=None):
        """The E = Z* A Z product: the H-matrix on the coarse basis block
        [N, c·nu_max] that the assembly hands it (c = all P ≤ 64 partitions),
        through the kernels and through the plain version on the same CUDA
        tensors, the plain version 64 columns at a time (its partial tiles
        take n_steps·tile·k scalars: 52 GB at k = 512 on the grid); not
        counted (the counts were read before).  Its bound: the blocks, X and
        Y moved once, or 2 flops a block entry and column, whichever takes
        longer.  With ``dense`` (the matrix in user numbering, which the
        H-matrix stores exactly when every block is dense), ``torch.mm`` on
        it is the library yardstick and the dense product a second oracle."""
        nc_pad = cs.Z_loc.shape[0] * cs.nu_max
        X = cs._z_apply(torch.eye(nc_pad, dtype=cs.Z_loc.dtype, device=dev))
        k = X.shape[1]
        yk = matvec(h, X)
        ms = event_ms(lambda: matvec(h, X))
        linalg.tiled_bucket_matvec = tiled_bucket_matvec_reference
        try:
            def plain():
                return torch.cat([matvec(h, X[:, j : j + 64].contiguous())
                                  for j in range(0, k, 64)], dim=1)

            yp = plain()
            plain_ms = event_ms(plain, reps=1)
        finally:
            linalg.tiled_bucket_matvec = tiled_bucket_matvec
        r = float(torch.linalg.norm(yk - yp) / torch.linalg.norm(yp))
        require(bool(torch.isfinite(yk).all()) and r <= tol_rel[X.dtype],
                f"wide product k = {k}: kernel vs plain rel {r:.3e}")
        entries = sum((1 + bool(b.mirror)) * (b.data.numel() if isinstance(b, ht.DenseBucket)
                                              else b.U.numel() + b.V.numel())
                      for b in h.dense_buckets + h.lr_buckets)
        by_bytes = 1e3 * X.element_size() * (entries + 2 * X.numel()) / PEAK_BYTES_S
        by_ops = 1e3 * 2 * k * entries / PEAK_FLOPS_S[X.dtype]
        out = dict(k=k, dtype=str(X.dtype), kernel_vs_plain_rel=r, product_ms=ms,
                   plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                   bound_by="bytes" if by_bytes >= by_ops else "operations",
                   block_entries=entries, library_ms=None)
        if dense is not None:
            perm = h.perm_t
            Xu = torch.empty_like(X)
            Xu[perm] = X
            yd = (dense @ Xu)[perm]
            out.update(library_ms=event_ms(lambda: torch.mm(dense, Xu)),
                       library_call="torch.mm on the dense matrix (user numbering)",
                       kernel_vs_dense_rel=float(torch.linalg.norm(yk - yd)
                                                 / torch.linalg.norm(yd)))
            require(out["kernel_vs_dense_rel"] <= tol_rel[X.dtype],
                    f"wide product k = {k}: kernel vs dense {out['kernel_vs_dense_rel']:.3e}")
        return out

    def true_residual(apply, x, b):
        return float(torch.linalg.norm(apply(x) - b) / torch.linalg.norm(b))

    n2, P2, tol2 = 20_000, 8, 1e-6
    pts2 = create_sphere(n2, seed=args.seed)
    pts2_d = torch.as_tensor(pts2.astype(np.float32), device=dev)
    gen2 = ht.KernelGenerator(laplace_kernel_symmetric, pts2_d, pts2_d)
    reset_counts()
    watch_plain(True)
    t0 = time.perf_counter()
    tree2 = ht.build_cluster_tree(pts2, max_leaf_size=256, n_partitions=P2)
    H2 = ht.build_hmatrix(gen2, tree2, epsilon=eps, eta=10.0)
    prepare_tiled_matvec(H2)
    ov2 = build_geometric_overlap(tree2, 0.05)
    sync()
    t_setup2 = time.perf_counter() - t0
    A2 = lambda v: matvec(H2, v)  # noqa: E731
    infos2: dict = {}
    t0 = time.perf_counter()
    cs2 = build_geneo_coarse_space(gen2, tree2, ov2, A2, nu=2, symmetry="S", store="local",
                                   infos=infos2)
    t_coarse2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver2 = DDMSolver(H2, gen2, tree2, schwarz="ras", overlap=ov2, coarse=cs2,
                        coarse_correction="additive", local_solver="dense")
    t_facto2 = time.perf_counter() - t0
    solver1 = DDMSolver(H2, gen2, tree2, schwarz="ras", overlap=ov2, local_solver="dense")
    rng2 = np.random.RandomState(args.seed + 2)
    b2 = H2 @ torch.as_tensor(rng2.randn(n2).astype(np.float32), device=dev)
    x1, it1 = solver1.solve(b2, tol=tol2, krylov="gmres", restart=60, maxiter=200)
    solves2 = []
    for _ in range(2):  # cold, warm
        t0 = time.perf_counter()
        x2, it2 = solver2.solve(b2, tol=tol2, krylov="gmres", restart=60, maxiter=200)
        solves2.append(time.perf_counter() - t0)
    res1, res2 = true_residual(H2.__matmul__, x1, b2), true_residual(H2.__matmul__, x2, b2)
    # the same coarse space in the replicated store: Q r must agree
    cs2_rep = build_geneo_coarse_space(gen2, tree2, ov2, A2, nu=2, symmetry="S",
                                       store="replicated")
    r2 = torch.as_tensor(rng2.randn(n2, 4).astype(np.float32), device=dev)
    q_loc, q_rep = cs2.coarse_solve(r2), cs2_rep.coarse_solve(r2)
    q_rel = float(torch.linalg.norm(q_loc - q_rep) / torch.linalg.norm(q_rep))
    watch_plain(False)
    counts2 = planned_counts(H2)
    wide2 = wide_product(H2, cs2)
    del cs2_rep, q_loc, q_rep
    emit(dict(phase="two_level_path", n=n2, subdomains=P2, epsilon=eps, overlap=0.05, nu=2,
              store="local", correction="additive", tol=tol2, setup_s=t_setup2,
              coarse_space_s=t_coarse2, facto_s=t_facto2,
              **{k: infos2[k] for k in GENEO_INFOS}, coarse_size=cs2.size,
              nu_per_subdomain=cs2.nu_per_subdomain.tolist(),
              local_size_max=solver2.infos["Local_size_max"],
              one_level_iterations=it1["Nb_it"], two_level_iterations=it2["Nb_it"],
              reference_iterations=dict(one_level=ref_iters_2["ras_gmres_1level_20k"],
                                        two_level=ref_iters_2["ras_geneo_additive_2level_20k"]),
              one_level_residual=res1, residual=res2, solve_cold_s=solves2[0],
              solve_warm_s=solves2[1], coarse_solve_local_vs_replicated_rel=q_rel,
              wide_product=wide2, **counts2))
    require(cs2.size == 2 * P2 and infos2["GenEO_coarse_space_size"] == cs2.size,
            f"two-level path: coarse size {cs2.size}")
    require(all(bool(torch.isfinite(v).all()) for v in (x1, x2)), "two-level path: non-finite x")
    require(res1 < 10 * tol2 and res2 < 10 * tol2,
            f"two-level path: true residuals {res1:.3e}, {res2:.3e} >= 10*tol")
    require(q_rel <= 1e-4, f"two-level path: Q r local against replicated {q_rel:.3e}")
    emit(dict(phase="profile", **profile_window(
        "geneo_build_n20000", lambda: build_geneo_coarse_space(
            gen2, tree2, ov2, A2, nu=2, symmetry="S", store="local"))))
    del H2, gen2, cs2, solver1, solver2
    torch.cuda.empty_cache()

    # ---------------- 17. two-level grid: where the coarse space pays ----------------
    # the 7-point grid Laplacian (float64, filled on the card), 64 subdomains,
    # ν = 8: one-level RAS, then the three corrections
    g = 32
    pts3, A3 = grid_laplacian((g, g, g), device=dev)
    n3, P3, nu3, tol3 = pts3.shape[0], 64, 8, 1e-6
    gen3 = ht.MatrixGenerator(A3)
    reset_counts()
    watch_plain(True)
    t0 = time.perf_counter()
    tree3 = ht.build_cluster_tree(pts3, max_leaf_size=64, n_partitions=P3)
    H3 = ht.build_hmatrix(gen3, tree3, epsilon=1e-8, eta=10.0)
    prepare_tiled_matvec(H3)
    ov3 = build_geometric_overlap(tree3, 1.5)
    sync()
    t_setup3 = time.perf_counter() - t0
    A3_apply = lambda v: matvec(H3, v)  # noqa: E731
    infos3: dict = {}
    t0 = time.perf_counter()
    cs3 = build_geneo_coarse_space(gen3, tree3, ov3, A3_apply, nu=nu3, symmetry="S",
                                   store="local", infos=infos3)
    t_coarse3 = time.perf_counter() - t0
    b3 = torch.as_tensor(np.random.RandomState(args.seed + 3).randn(n3), device=dev)
    runs3 = {}
    for corr in (None, "additive", "deflated", "balanced"):
        t0 = time.perf_counter()
        s3 = DDMSolver(H3, gen3, tree3, schwarz="ras", overlap=ov3, local_solver="dense",
                       coarse=None if corr is None else cs3, coarse_correction=corr or "additive")
        t_facto3 = time.perf_counter() - t0
        t0 = time.perf_counter()
        x3, it3 = s3.solve(b3, tol=tol3, krylov="gmres", restart=60, maxiter=300)
        sync()
        runs3[corr or "one_level"] = dict(
            iterations=it3["Nb_it"], facto_s=t_facto3, solve_s=time.perf_counter() - t0,
            residual=true_residual(lambda v: A3 @ v, x3, b3),
            finite=bool(torch.isfinite(x3).all()))
        del s3
    watch_plain(False)
    counts3 = planned_counts(H3)
    wide3 = wide_product(H3, cs3, dense=A3)
    info3 = ht.hmatrix_info(H3)
    two_level_min = min(v["iterations"] for k, v in runs3.items() if k != "one_level")
    emit(dict(phase="two_level_grid", grid=[g, g, g], n=n3, dtype="float64", subdomains=P3,
              leaf=64, epsilon=1e-8, overlap=1.5, nu=nu3, store="local", tol=tol3,
              setup_s=t_setup3, coarse_space_s=t_coarse3,
              **{k: infos3[k] for k in GENEO_INFOS}, coarse_size=cs3.size,
              sum_nu=int(np.sum(cs3.nu_per_subdomain)),
              n_dense_blocks=info3["n_dense_blocks"],
              n_low_rank_blocks=info3["n_low_rank_blocks"],
              n_false_positive=info3["n_false_positive"], runs=runs3,
              wide_product=wide3, max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
              **counts3))
    require(cs3.size == int(np.sum(cs3.nu_per_subdomain)) == nu3 * P3,
            f"two-level grid: coarse size {cs3.size}, nu {cs3.nu_per_subdomain.tolist()}")
    require(all(v["finite"] and v["residual"] < 10 * tol3 for v in runs3.values()),
            f"two-level grid: residuals {runs3}")
    require(two_level_min < runs3["one_level"]["iterations"],
            f"two-level grid: no correction beat one level: {runs3}")
    del cs3

    # ---------------- 18. flat BLR Cholesky of the grid Laplacian ----------------
    # cholesky_factorization(method="blr") of phase 17's H-matrix (f64,
    # every block dense), solved with cholesky_solve; residual against the
    # matrix itself
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    mem_start3 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    Fc3 = ht.cholesky_factorization(H3, tree3, epsilon=1e-8, method="blr")
    sync()
    t_chol3 = time.perf_counter() - t0
    b3c = torch.as_tensor(np.random.RandomState(args.seed + 4).randn(n3, 2), device=dev)
    t0 = time.perf_counter()
    x3c = ht.cholesky_solve(Fc3, b3c)
    sync()
    t_csolve3 = time.perf_counter() - t0
    res3c = true_residual(lambda v: A3 @ v, x3c, b3c)
    emit(dict(phase="blr_cholesky_grid", grid=[g, g, g], n=n3, dtype="float64", block_size=256,
              epsilon=1e-8, n_cells=Fc3.nL, cell_size=Fc3.b, R_half=Fc3.R_half,
              cholesky_s=t_chol3, solve_s=t_csolve3, residual=res3c,
              backward_error_est=Fc3.info["backward_error_est"],
              n_rank_capped_cells=Fc3.info["n_rank_capped_cells"],
              factor_bytes=Fc3.memory_bytes(), **Fc3.compression_info(),
              allocated_at_start_bytes=mem_start3,
              max_memory_allocated_bytes=torch.cuda.max_memory_allocated()))
    require(Fc3.kind == "chol" and bool(torch.isfinite(x3c).all()), "grid Cholesky: output")
    require(res3c < 1e-6, f"grid Cholesky: residual {res3c:.3e}")
    require(matvec.products == 0, "grid Cholesky: a product kernel ran")
    del H3, gen3, A3, Fc3
    torch.cuda.empty_cache()

    # ---------------- 19, 20. two-level BLR: the JAX bench's blr2 rows ----------------
    def blr2_row(n_b, nested):
        """bench.py:335-381 on the port: sphere, f32, leaf 256, ε = 1e-4,
        build_blr2 defaults; blr2_lu with the error estimate, cold and warm;
        10 solves of 8 right-hand sides; checks as the bench's plus a true
        residual on 256 generator rows."""
        eps_b = 1e-4
        pts_b = create_sphere(n_b, seed=args.seed)
        pts_bd = torch.as_tensor(pts_b.astype(np.float32), device=dev)
        gen_b = ht.KernelGenerator(laplace_kernel_symmetric, pts_bd, pts_bd)
        tree_b = ht.build_cluster_tree(pts_b, max_leaf_size=256)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        mem_start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        A_b = ht.build_blr2(gen_b, tree_b, epsilon=eps_b)
        sync()
        t_build = time.perf_counter() - t0
        peak_build = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        F_b = ht.blr2_lu(A_b, error_estimate=True)
        sync()
        t_lu = time.perf_counter() - t0
        peak_lu = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        ht.blr2_lu(A_b, error_estimate=False)
        sync()
        t_lu_warm = time.perf_counter() - t0
        rng_b = np.random.RandomState(args.seed + 5)
        b_b = torch.as_tensor(rng_b.randn(n_b, 8).astype(np.float32), device=dev)
        ht.blr2_solve(F_b, b_b, user_numbering=True)
        sync()
        t0 = time.perf_counter()
        for _ in range(10):
            x_b = ht.blr2_solve(F_b, b_b, user_numbering=True)
        sync()
        t_solve = (time.perf_counter() - t0) / 10
        peak_b = max(peak_build, peak_lu, torch.cuda.max_memory_allocated())
        rows_b = torch.as_tensor(rng_b.choice(n_b, 256, replace=False), device=dev)
        A_rows_b = gen_b.block(rows_b, torch.arange(n_b, device=dev)).double()
        res_b = float(torch.linalg.norm(A_rows_b @ x_b.double() - b_b[rows_b].double())
                      / torch.linalg.norm(b_b[rows_b].double()))
        flops = blr2_lu_flops(A_b)
        prof = profile_window(f"blr2_lu_warm_n{n_b}",
                              lambda: ht.blr2_lu(A_b, error_estimate=False))
        mode = "nested" if A_b.info["nested_diag"] else A_b.diag_mode
        row = dict(
            phase=f"blr2_n{n_b}", n=n_b, epsilon=eps_b, dtype="float32",
            build_s=t_build, build_aca_s=A_b.info["offdiag_aca_walltime"],
            build_diag_s=A_b.info["diag_build_walltime"], lu_s=t_lu, lu_warm_s=t_lu_warm,
            lu_flops_model=flops, lu_gflops=flops / t_lu_warm / 1e9, solve_s=t_solve, nrhs=8,
            backward_error_est=F_b.info["backward_error_est"],
            n_rank_capped=F_b.info["n_rank_capped_pairs"], diag_mode=mode,
            n_levels=A_b.info["n_levels"], factor_bytes=F_b.memory_bytes(),
            n_panels=A_b.nC, panel_size=A_b.P, panel_rank_cap=A_b.R,
            n_aca_failed=A_b.info["n_aca_failed"], residual_256_rows=res_b,
            max_memory_allocated_bytes=peak_b, allocated_at_start_bytes=mem_start,
            build_peak_bytes=peak_build, lu_peak_bytes=peak_lu, lu_warm_profile=prof,
            product_kernel_launches=matvec.products)
        emit(row)
        require(bool(torch.isfinite(x_b).all()) and tuple(x_b.shape) == (n_b, 8),
                f"blr2_n{n_b}: solve output")
        require(row["backward_error_est"] < 100 * eps_b,
                f"blr2_n{n_b}: backward error {row['backward_error_est']:.3e} >= 100*eps")
        require(res_b < 10 * eps_b, f"blr2_n{n_b}: residual {res_b:.3e} >= 10*eps")
        require(mode == ("nested" if nested else "dense") and row["n_levels"] >= (3 if nested else 2),
                f"blr2_n{n_b}: diag mode {mode}, {row['n_levels']} levels")
        del A_b, F_b, gen_b, A_rows_b
        torch.cuda.empty_cache()

    blr2_row(10_000, nested=False)
    blr2_row(100_000, nested=True)

    # ---------------- 21. flat BLR LU of the sphere, and back to an H-matrix ----------------
    # lu_factorization(method="blr") and lu_solve on cell 6's H-matrix
    # (sphere n = 20,000, f32, ε = 1e-3); the unfactorized BLR matrix re-exported
    # by blr_to_hmatrix and applied at k = 8 through the unplanned kernels
    n6, eps6 = 20_000, 1e-4
    pts6 = create_sphere(n6, seed=args.seed)
    pts6_d = torch.as_tensor(pts6.astype(np.float32), device=dev)
    gen6 = ht.KernelGenerator(laplace_kernel_symmetric, pts6_d, pts6_d)
    tree6 = ht.build_cluster_tree(pts6, max_leaf_size=256, n_partitions=8)
    H6 = ht.build_hmatrix(gen6, tree6, epsilon=eps, eta=10.0)
    reset_counts()
    t0 = time.perf_counter()
    F6 = ht.lu_factorization(H6, tree6, epsilon=eps6, method="blr")
    sync()
    t_lu6 = time.perf_counter() - t0
    rng6 = np.random.RandomState(args.seed + 6)
    x6_true = torch.as_tensor(rng6.randn(n6, 2).astype(np.float32), device=dev)
    b6 = H6 @ x6_true
    t0 = time.perf_counter()
    x6 = ht.lu_solve(F6, b6)
    sync()
    t_solve6 = time.perf_counter() - t0
    res6_h = true_residual(H6.__matmul__, x6, b6)
    rows6 = torch.as_tensor(rng6.choice(n6, 256, replace=False), device=dev)
    A_rows6 = gen6.block(rows6, torch.arange(n6, device=dev)).double()
    res6_g = float(torch.linalg.norm(A_rows6 @ x6.double() - b6[rows6].double())
                   / torch.linalg.norm(b6[rows6].double()))
    emit(dict(phase="blr_lu_sphere", n=n6, dtype="float32", hmatrix_epsilon=eps,
              blr_epsilon=eps6, block_size=256, n_cells=F6.nL, cell_size=F6.b,
              R_half=F6.R_half, lu_s=t_lu6, solve_s=t_solve6, nrhs=2,
              backward_error_est=F6.info["backward_error_est"],
              n_rank_capped_cells=F6.info["n_rank_capped_cells"],
              factor_bytes=F6.memory_bytes(), residual_vs_hmatrix=res6_h,
              residual_256_generator_rows=res6_g))
    require(bool(torch.isfinite(x6).all()), "flat BLR LU: non-finite solution")
    require(res6_h < 10 * eps6, f"flat BLR LU: residual against H {res6_h:.3e}")
    require(res6_g < 10 * eps, f"flat BLR LU: residual on generator rows {res6_g:.3e}")
    del F6, A_rows6
    # the round trip: the BLR matrix as an HMatrix, its product through the
    # unplanned kernels (one dense and one low-rank term) against the BLR
    # product, and the same product through the plain versions
    B6 = ht.to_blr(H6, tree6, epsilon=eps6)
    Hb6 = ht.blr_to_hmatrix(B6)
    x6k = torch.as_tensor(rng6.randn(n6, 8).astype(np.float32), device=dev)
    perm6 = torch.as_tensor(tree6.permutation, device=dev)
    reset_counts()
    watch_plain(True)
    y6 = Hb6 @ x6k
    sync()
    watch_plain(False)
    collect_launches()
    launches6 = (dense_bucket_matvec.launches, lr_bucket_matvec.launches, matvec.products,
                 plain_calls[0])
    y6_blr = torch.empty_like(y6)
    y6_blr[perm6] = ht.blr_matvec(B6, x6k[perm6])
    rt_rel = float(torch.linalg.norm(y6 - y6_blr) / torch.linalg.norm(y6_blr))
    x6c = x6k[perm6]
    rt_ms = event_ms(lambda: matvec(Hb6, x6c))
    y6k = matvec(Hb6, x6c)
    linalg.dense_bucket_matvec = dense_bucket_matvec_reference
    linalg.lr_bucket_matvec = lr_bucket_matvec_reference
    try:
        y6p = matvec(Hb6, x6c)
        rt_plain_ms = event_ms(lambda: matvec(Hb6, x6c))
    finally:
        linalg.dense_bucket_matvec = dense_bucket_matvec
        linalg.lr_bucket_matvec = lr_bucket_matvec
    rt_vs_plain = float(torch.linalg.norm(y6k - y6p) / torch.linalg.norm(y6p))
    emit(dict(phase="blr_to_hmatrix", n=n6, k=8, n_dense_cells=int(Hb6.dense_buckets[0].n_blocks),
              n_lr_cells=int(Hb6.lr_buckets[0].n_blocks),
              lr_rank_padded=Hb6.lr_buckets[0].rank_padded,
              dense_launches=launches6[0], lr_launches=launches6[1], products=launches6[2],
              plain_version_calls=launches6[3], rel_vs_blr_matvec=rt_rel,
              kernel_vs_plain_rel=rt_vs_plain, product_ms=rt_ms, plain_ms=rt_plain_ms))
    require(launches6[:3] == (1, 1, 1) and launches6[3] == 0,
            f"blr_to_hmatrix: launches (dense, lr, products, plain) {launches6}")
    require(rt_rel <= 1e-5 and rt_vs_plain <= 1e-5,
            f"blr_to_hmatrix: rel {rt_rel:.3e}, kernel vs plain {rt_vs_plain:.3e}")
    del B6, Hb6, y6, y6_blr, y6k, y6p

    # ---------------- 22. the flagship with compressed local solves ----------------
    # the real flagship (n = 100,000, 64 subdomains, RAS overlap 0.02,
    # GMRES(60) to 1e-6) with local_solver="blr" (ε = 1e-4, block 256) beside
    # the dense local inverses
    blr_eps = 1e-4
    tree64 = ht.build_cluster_tree(pts, max_leaf_size=256, n_partitions=P)
    H64 = ht.build_hmatrix(gen, tree64, epsilon=eps, eta=10.0)
    prepare_tiled_matvec(H64)
    ov64 = build_geometric_overlap(tree64, 0.02)
    sync()
    s_dense = DDMSolver(H64, gen, tree64, schwarz="ras", overlap=ov64, local_solver="dense")
    dense_bytes = s_dense.precond.inv.numel() * s_dense.precond.inv.element_size()
    b64 = H64 @ torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
    x_d, it_d = s_dense.solve(b64, tol=tol, krylov="gmres", restart=60, maxiter=200)
    del s_dense
    torch.cuda.empty_cache()
    reset_counts()
    watch_plain(True)
    setups = []
    for _ in range(2):  # cold, warm
        t0 = time.perf_counter()
        s_blr = DDMSolver(H64, gen, tree64, schwarz="ras", overlap=ov64, local_solver="blr",
                          blr_epsilon=blr_eps, blr_block_size=256)
        setups.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    x_b64, it_b = s_blr.solve(b64, tol=tol, krylov="gmres", restart=60, maxiter=200)
    t_solve_b = time.perf_counter() - t0
    watch_plain(False)
    counts22 = planned_counts(H64)
    res_b64 = true_residual(H64.__matmul__, x_b64, b64)
    res_d64 = true_residual(H64.__matmul__, x_d, b64)
    emit(dict(phase="ddm_blr_local_solves", n=n, subdomains=P, overlap=0.02, tol=tol,
              local_solver="blr", blr_epsilon=blr_eps, blr_block_size=256,
              setup_cold_s=setups[0], setup_warm_s=setups[1], solve_s=t_solve_b,
              iterations=it_b["Nb_it"], dense_iterations=it_d["Nb_it"], residual=res_b64,
              dense_residual=res_d64, local_factor_bytes=s_blr.precond.memory_bytes(),
              dense_inverse_bytes=dense_bytes, infos=it_b, **counts22))
    require(bool(torch.isfinite(x_b64).all()), "BLR local solves: non-finite solution")
    require(abs(it_b["Nb_it"] - it_d["Nb_it"]) <= 2,
            f"BLR local solves: {it_b['Nb_it']} iterations against dense {it_d['Nb_it']}")
    require(res_b64 < 10 * tol, f"BLR local solves: residual {res_b64:.3e} >= 10*tol")
    del s_blr, H64
    torch.cuda.empty_cache()

    # ---------------- 23. cell 6 with two-level local solves ----------------
    # sphere n = 20,000, 8 subdomains, overlap 0.05, local_solver="blr2" with
    # blr_coarse_size=1024: every subdomain (about 2,800 points) takes the
    # two-level format
    prepare_tiled_matvec(H6)
    ov6 = build_geometric_overlap(tree6, 0.05)
    b6s = H6 @ torch.as_tensor(rng6.randn(n6).astype(np.float32), device=dev)
    reset_counts()
    watch_plain(True)
    t0 = time.perf_counter()
    s6 = DDMSolver(H6, gen6, tree6, schwarz="ras", overlap=ov6, local_solver="blr2",
                   blr_epsilon=blr_eps, blr_coarse_size=1024)
    t_setup6 = time.perf_counter() - t0
    t0 = time.perf_counter()
    x6s, it6 = s6.solve(b6s, tol=tol, krylov="gmres", restart=60, maxiter=200)
    t_solve6s = time.perf_counter() - t0
    watch_plain(False)
    counts23 = planned_counts(H6)
    res6s = true_residual(H6.__matmul__, x6s, b6s)
    kinds6 = [type(F).__name__ for F in s6.precond.factors]
    emit(dict(phase="ddm_blr2_local_solves", n=n6, subdomains=8, overlap=0.05, tol=tol,
              local_solver="blr2", blr_epsilon=blr_eps, blr_coarse_size=1024,
              subdomain_sizes=[int(i.numel()) for i in s6.precond.idx], factor_kinds=kinds6,
              panels=[int(F.nC) for F in s6.precond.factors], setup_s=t_setup6,
              solve_s=t_solve6s, iterations=it6["Nb_it"],
              one_level_dense_iterations=it1["Nb_it"], residual=res6s,
              local_factor_bytes=s6.precond.memory_bytes(), **counts23))
    require(all(k == "TwoLevelBLR" for k in kinds6),
            f"blr2 local solves: not every subdomain took the two-level format: {kinds6}")
    require(bool(torch.isfinite(x6s).all()) and res6s < 10 * tol,
            f"blr2 local solves: residual {res6s:.3e}")
    require(abs(it6["Nb_it"] - it1["Nb_it"]) <= 2,
            f"blr2 local solves: {it6['Nb_it']} iterations against dense {it1['Nb_it']}")
    del s6, H6, gen6
    torch.cuda.empty_cache()
    # ---------------- 24. distributed operator: eight partitions on the card ----------------
    # the flagship operator row-partitioned over P = 8 partitions, all on this
    # card (the tree of phase 7): builds, g2g and l2l products through the
    # unplanned kernels, and RAS + GMRES on the partition slices beside the
    # replicated solver on the same operator
    from htool_tpu_torch.parallel import (
        build_distributed_from_local_hmatrices,
        build_distributed_hmatrix,
        default_mesh,
        distributed_hmatrix_info,
        global_mesh,
        initialize_multihost,
        shutdown_multihost,
    )
    from htool_tpu_torch.hmatrix.blr import blr_solve
    from htool_tpu_torch.solvers import DistributedDDMSolver
    from htool_tpu_torch.solvers.dist_ddm import (
        _blr_local_solve,
        _stack_blr_factors,
        _subdomain_blr_factors,
        build_halo_exchange,
    )

    t_phase = time.perf_counter()
    del HS, hs_buckets, pts6_d
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem_start24 = torch.cuda.memory_allocated()
    with warnings.catch_warnings():  # the scan touches deprecated module attributes
        warnings.simplefilter("ignore", FutureWarning)
        live24 = sorted(((t.numel() * t.element_size(), list(t.shape), str(t.dtype))
                         for t in gc.get_objects() if torch.is_tensor(t) and t.is_cuda),
                        reverse=True)[:6]
    emit(dict(phase="dist_allocated_at_start", allocated_gb=mem_start24 / 1e9,
              largest_live_tensors=live24))
    mesh8 = default_mesh(P8, device=dev)
    builds24 = []
    for _ in range(2):  # cold, warm
        t0 = time.perf_counter()
        D24 = build_distributed_hmatrix(gen, tree8, mesh8, epsilon=eps, eta=10.0)
        sync()
        builds24.append(time.perf_counter() - t0)
    sym_builds24 = []
    for _ in range(2):  # cold, warm: phase 7's symmetric block rows, wired
        t0 = time.perf_counter()
        rows_s = [ht.HMatrixBuilder(epsilon=eps, eta=10.0, symmetry="S", UPLO="L",
                                    partition_number_for_symmetry=p).build(gen, tree8,
                                                                           target_partition=p)
                  for p in range(P8)]
        DS24 = build_distributed_from_local_hmatrices(rows_s, tree8, mesh8, symmetry="S",
                                                      UPLO="L")
        sync()
        sym_builds24.append(time.perf_counter() - t0)
        del rows_s

    def part_bytes(d):
        """Bytes of each partition's padded bucket slices."""
        return sum(t[0].numel() * t.element_size() for b in d.dense_buckets + d.lr_buckets
                   for t in ((b.data,) if isinstance(b, ht.DenseBucket) else (b.U, b.V)))

    d_tensors = [t for d in (D24, DS24) for b in d.dense_buckets + d.lr_buckets
                 for t in ((b.data,) if isinstance(b, ht.DenseBucket) else (b.U, b.V))
                 + (b.t_off, b.s_off)]
    require(all(t.is_cuda for t in d_tensors) and D24.device.type == "cuda",
            "distributed operator: a bucket tensor is not on the card")
    del d_tensors
    require(D24.dense_buckets[0].data.shape[0] == P8 and mesh8.n_local == P8,
            "distributed operator: not 8 partitions in this process")
    # the global H-matrix on the same tree, and its products (not counted)
    H8 = ht.build_hmatrix(gen, tree8, epsilon=eps, eta=10.0)
    x24 = {k: torch.as_tensor(rng.randn(n, k).astype(np.float32), device=dev) for k in (1, 8)}
    ref24 = {(op, k): matvec_user(H8, x24[k], op=op) for op in ("N", "T") for k in (1, 8)}
    sync()
    del H8

    reset_counts()
    watch_plain(True)
    y24, ys24 = {}, {}
    for k in (1, 8):
        for op in ("N", "T"):
            y24[op, k] = D24.matvec(x24[k], op=op)
            ys24[op, k] = DS24.matvec(x24[k], op=op)
        xl = D24.to_local_layout(x24[k][perm8])
        y_l = torch.empty_like(x24[k])
        y_l[perm8] = D24.to_global_layout(D24.matvec_local(xl))
        y24["l2l_N", k] = y_l
    sync()
    # launches a product: one wrapper call per bucket term over the blocks of
    # all 8 partitions (the per-partition route made 8 x terms); every
    # low-rank term is two CUDA launches
    per_product24 = {}
    for name, d in (("plain_rows", D24), ("symmetric_rows", DS24)):
        for k in (1, 8):
            xl = d.to_local_layout(x24[k][perm8])
            for prod, op, fn in (("g2g_N", "N", lambda d=d, k=k: d.matvec(x24[k])),
                                 ("g2g_T", "T", lambda d=d, k=k: d.matvec(x24[k], op="T")),
                                 ("l2l_N", "N", lambda d=d, xl=xl: d.matvec_local(xl))):
                terms = sum(len(linalg._bucket_terms(b, op, d.symmetry))
                            for b in d.dense_buckets + d.lr_buckets)
                l0 = dense_bucket_matvec.launches + lr_bucket_matvec.launches
                s0 = lr_bucket_matvec.cuda_launches - lr_bucket_matvec.launches
                fn()
                sync()
                per_product24[f"{name}/{prod}/k{k}"] = dict(
                    launches=dense_bucket_matvec.launches + lr_bucket_matvec.launches - l0,
                    bucket_terms=terms, per_partition_route_launches=P8 * terms,
                    two_stage_terms=lr_bucket_matvec.cuda_launches - lr_bucket_matvec.launches
                    - s0)
    t0 = time.perf_counter()
    s24 = DistributedDDMSolver(D24, gen, tree8, schwarz="ras", overlap_radius=0.02,
                               local_solver="dense")
    setup24 = [time.perf_counter() - t0]
    x_true24 = torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
    b24 = D24 @ x_true24
    solves24 = []
    for _ in range(2):  # cold, warm
        t0 = time.perf_counter()
        xd24, it24 = s24.solve(b24, tol=tol, krylov="gmres", restart=60, maxiter=200)
        solves24.append(time.perf_counter() - t0)
    res24 = true_residual(D24.__matmul__, xd24, b24)
    sync()
    watch_plain(False)
    plain24 = plain_calls[0]
    collect_launches()
    launches24 = dict(dense=dense_bucket_matvec.launches, lr=lr_bucket_matvec.launches,
                      tiled=tiled_bucket_matvec.launches, products=matvec.products)
    t0 = time.perf_counter()
    s24 = DistributedDDMSolver(D24, gen, tree8, schwarz="ras", overlap_radius=0.02,
                               local_solver="dense")
    setup24.append(time.perf_counter() - t0)
    prof24 = profile_window("dist_ras_gmres_warm", lambda: s24.solve(
        b24, tol=tol, krylov="gmres", restart=60, maxiter=200),
        groups=dict(products=("bucket_stream_kernel", "bucket_matvec_kernel"),
                    triangular_solves=("trsv", "trsm")))
    t0 = time.perf_counter()
    s24r = DDMSolver(D24, gen, tree8, schwarz="ras", overlap_radius=0.02, local_solver="dense")
    setup24r = time.perf_counter() - t0
    t0 = time.perf_counter()
    xr24, itr24 = s24r.solve(b24, tol=tol, krylov="gmres", restart=60, maxiter=200)
    solve24r = time.perf_counter() - t0
    res24r = true_residual(D24.__matmul__, xr24, b24)
    del s24r
    ms24 = {f"g2g_{op}_k{k}": event_ms(lambda op=op, k=k: D24.matvec(x24[k], op=op))
            for k in (1, 8) for op in ("N", "T")}
    for k in (1, 8):
        xl = D24.to_local_layout(x24[k][perm8])
        ms24[f"l2l_N_k{k}"] = event_ms(lambda xl=xl: D24.matvec_local(xl))
    ms24["symmetric_g2g_N_k8"] = event_ms(lambda: DS24.matvec(x24[8]))
    err_global24 = {f"{op}/k{k}": rel(y24[op, k], ref24[op, k]) for op in ("N", "T")
                    for k in (1, 8)}
    err_global24.update({f"l2l_N/k{k}": rel(y24["l2l_N", k], ref24["N", k]) for k in (1, 8)})
    # the kernel is symmetric on one point set: the sampled rows of A are
    # those of Aᵀ, so the row oracle also holds the 'T' products
    err_oracle24 = {f"{key[0]}/k{key[1]}": rel(v[sub_t], A_rows @ x24[key[1]].double())
                    for key, v in y24.items()}
    err_oracle24.update({f"symmetric_{op}/k{k}": rel(ys24[op, k][sub_t],
                                                      A_rows @ x24[k].double())
                         for op, k in ys24})
    info24 = distributed_hmatrix_info(D24)
    emit(dict(
        phase="dist_n100000", n=n, partitions=P8, epsilon=eps, dtype="float32",
        allocated_at_start_bytes=mem_start24, largest_live_tensors_at_start=live24,
        build_cold_s=builds24[0], build_warm_s=builds24[1],
        symmetric_rows_build_and_wire_cold_s=sym_builds24[0],
        symmetric_rows_build_and_wire_warm_s=sym_builds24[1],
        m_loc_max=D24.m_loc_max, part_sizes=D24.part_sizes.tolist(),
        bytes_per_partition=part_bytes(D24), symmetric_bytes_per_partition=part_bytes(DS24),
        compression_ratio=info24["compression_ratio"],
        n_dense_buckets=len(D24.dense_buckets), n_lr_buckets=len(D24.lr_buckets),
        product_ms=ms24, launches_per_product=per_product24,
        rel_vs_global_hmatrix=err_global24, rel_vs_oracle_256_rows=err_oracle24,
        halo_colors=s24.halo.n_colors, H_max=s24.halo.H_max, n_ext_max=s24.halo.n_ext_max,
        setup_cold_s=setup24[0], setup_warm_s=setup24[1], solve_cold_s=solves24[0],
        solve_warm_s=solves24[1], iterations=it24["Nb_it"], residual=res24,
        replicated_setup_s=setup24r, replicated_solve_s=solve24r,
        replicated_iterations=itr24["Nb_it"], replicated_residual=res24r,
        solve_warm_profile=prof24, launches=launches24, plain_version_calls=plain24,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(), infos=it24,
        phase_s=time.perf_counter() - t_phase))
    require(max(err_global24.values()) <= 1e-5,
            f"distributed products against the global H-matrix: {err_global24}")
    require(max(err_oracle24.values()) < eps, f"distributed products against the oracle: "
                                               f"{err_oracle24}")
    require(launches24["dense"] > 0 and launches24["lr"] > 0 and launches24["tiled"] == 0
            and plain24 == 0, f"distributed path launches {launches24}, plain calls {plain24}")
    require(all(v["launches"] == v["bucket_terms"] for v in per_product24.values()),
            f"distributed products: launches a product against bucket terms {per_product24}")
    require(bool(torch.isfinite(xd24).all()) and res24 < 10 * tol,
            f"distributed RAS: residual {res24:.3e}")
    require(it24["Nb_it"] == itr24["Nb_it"] and res24r < 10 * tol,
            f"distributed RAS took {it24['Nb_it']} iterations, the replicated solver "
            f"{itr24['Nb_it']} (residual {res24r:.3e})")

    # ---------------- 25. the process-group route over NCCL, world size 1 ----------------
    # the same operator on a mesh of one NCCL process (a file store in a
    # temporary directory): every collective goes through the group
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp25:
        initialize_multihost(f"file://{tmp25}/store", 1, 0, device=dev)
        try:
            mesh25 = global_mesh(P8, device=dev)
            backend25 = mesh25.backend
            D25 = build_distributed_hmatrix(gen, tree8, mesh25, epsilon=eps, eta=10.0)
            reset_counts()
            watch_plain(True)
            y25 = {op: D25.matvec(x24[8], op=op) for op in ("N", "T")}
            t0 = time.perf_counter()
            s25 = DistributedDDMSolver(D25, gen, tree8, schwarz="ras", overlap_radius=0.02,
                                       local_solver="dense")
            setup25 = time.perf_counter() - t0
            t0 = time.perf_counter()
            x25, it25 = s25.solve(b24, tol=tol, krylov="gmres", restart=60, maxiter=200)
            solve25 = time.perf_counter() - t0
            res25 = true_residual(D25.__matmul__, x25, b24)
            sync()
            watch_plain(False)
            plain25 = plain_calls[0]
            collect_launches()
            launches25 = dict(dense=dense_bucket_matvec.launches, lr=lr_bucket_matvec.launches)
            ms25 = {f"g2g_{op}_k8": event_ms(lambda op=op: D25.matvec(x24[8], op=op))
                    for op in ("N", "T")}
            del s25, D25
        finally:
            shutdown_multihost()
    rel25 = {op: rel(y25[op], y24[op, 8]) for op in ("N", "T")}
    x_rel25 = rel(x25, xd24)
    emit(dict(phase="dist_nccl_world1", backend=backend25, partitions=P8, world_size=1,
              product_ms=ms25, rel_vs_phase24=rel25, setup_s=setup25, solve_s=solve25,
              iterations=it25["Nb_it"], phase24_iterations=it24["Nb_it"], residual=res25,
              solution_rel_vs_phase24=x_rel25, launches=launches25,
              plain_version_calls=plain25, phase_s=time.perf_counter() - t_phase))
    require(backend25 == "nccl", f"process group backend {backend25}")
    require(max(rel25.values()) <= 1e-6 and x_rel25 <= 1e-6,
            f"NCCL route against phase 24: products {rel25}, solution {x_rel25:.3e}")
    require(it25["Nb_it"] == it24["Nb_it"] and res25 < 10 * tol,
            f"NCCL route RAS: {it25['Nb_it']} iterations (phase 24: {it24['Nb_it']}), "
            f"residual {res25:.3e}")
    require(launches25["dense"] > 0 and launches25["lr"] > 0 and plain25 == 0,
            f"NCCL route launches {launches25}, plain calls {plain25}")
    # phase 28's reference: torch_multichip.py's x and right-hand side (made
    # from the seed as it makes them) through phase 24's operator and solver
    x28 = torch.as_tensor(np.random.RandomState(args.seed).randn(n, 8).astype(np.float32),
                          device=dev)
    b28 = torch.as_tensor(np.random.RandomState(args.seed + 1).randn(n).astype(np.float32),
                          device=dev)
    xs28, it28 = s24.solve(b28, tol=tol, krylov="gmres", restart=60, maxiter=200)
    ref28 = dict(y_N=D24.matvec(x28).cpu(), y_T=D24.matvec(x28, op="T").cpu(), x=xs28.cpu(),
                 iterations=it28["Nb_it"])
    del s24, D24, DS24, y24, ys24, ref24, x28, b28, xs28
    torch.cuda.empty_cache()

    # ---------------- 26. cell 6 distributed: two levels and BLR local solves ----------------
    # sphere n = 20,000, 8 partitions, overlap 0.05, GenEO ν = 2 on the
    # distributed operator: the two-level additive solve on the partition
    # slices with the replicated and the local store, beside the replicated
    # two-level solver; one level with BLR local solves (ε 1e-4, block 256)
    # beside dense ones.  In float32 (cell 6) and again in float64: the
    # distributed solver's local LU and the replicated solver's explicit
    # inverses differ by rounding, which in float32 can move the iteration
    # at which the residual crosses tol; the counts must be equal in float64
    t_phase = time.perf_counter()
    n26 = 20_000
    pts26 = create_sphere(n26, seed=args.seed)
    tree26 = ht.build_cluster_tree(pts26, max_leaf_size=256, n_partitions=8)
    ov26 = build_geometric_overlap(tree26, 0.05)
    reset_counts()
    watch_plain(True)

    def cell26(real):
        pts_d26 = torch.as_tensor(pts26.astype(real), device=dev)
        gen26 = ht.KernelGenerator(laplace_kernel_symmetric, pts_d26, pts_d26)
        t0 = time.perf_counter()
        D26 = build_distributed_hmatrix(gen26, tree26, default_mesh(8, device=dev),
                                        epsilon=eps, eta=10.0)
        sync()
        out = dict(dtype=str(D26.dtype), build_s=time.perf_counter() - t0, coarse_space_s={},
                   runs={})
        b26 = D26 @ torch.as_tensor(np.random.RandomState(args.seed + 7).randn(n26)
                                    .astype(real), device=dev)

        def A26(v):
            return D26.to_global_layout(D26.matvec_local(D26.to_local_layout(v)))

        cs26 = {}
        for store in ("replicated", "local"):
            t0 = time.perf_counter()
            cs26[store] = build_geneo_coarse_space(gen26, tree26, ov26, A26, nu=2,
                                                   symmetry="S", store=store)
            out["coarse_space_s"][store] = time.perf_counter() - t0
        out["coarse_size"] = cs26["local"].size

        def run(name, solver_cls, **kw):
            t0 = time.perf_counter()
            s = solver_cls(D26, gen26, tree26, schwarz="ras", overlap=ov26, **kw)
            t_setup = time.perf_counter() - t0
            t0 = time.perf_counter()
            x, it = s.solve(b26, tol=tol, krylov="gmres", restart=60, maxiter=200)
            sync()
            out["runs"][name] = dict(iterations=it["Nb_it"], setup_s=t_setup,
                                     solve_s=time.perf_counter() - t0,
                                     residual=true_residual(D26.__matmul__, x, b26),
                                     finite=bool(torch.isfinite(x).all()))

        run("replicated_two_level", DDMSolver, coarse=cs26["replicated"],
            coarse_correction="additive")
        for store in ("replicated", "local"):
            run(f"dist_two_level_{store}", DistributedDDMSolver, coarse=cs26[store],
                coarse_correction="additive")
        if real == np.float32:
            run("dist_one_level_dense", DistributedDDMSolver, local_solver="dense")
            run("dist_one_level_blr", DistributedDDMSolver, local_solver="blr",
                blr_epsilon=1e-4, blr_block_size=256)
        return out

    cells26 = {"float32": cell26(np.float32), "float64": cell26(np.float64)}
    watch_plain(False)
    plain26 = plain_calls[0]
    collect_launches()
    # one application of the stacked BLR local solve (all 8 subdomains in one
    # sweep of batched steps) against each subdomain's blr_solve, on the
    # float32 factors in float32 and in float64
    pts_d26 = torch.as_tensor(pts26.astype(np.float32), device=dev)
    gen26 = ht.KernelGenerator(laplace_kernel_symmetric, pts_d26, pts_d26)
    halo26 = build_halo_exchange(tree26, ov26)
    factors26 = _subdomain_blr_factors(gen26, tree26, ov26, range(8), 1e-4, 256)
    sf26 = _stack_blr_factors(factors26, halo26.n_ext_max, dev)
    stacked26 = dict(B=sf26.B, nL=sf26.nL, Rh=sf26.Rh,
                     per_subdomain_nL=[F.nL for F in factors26])
    for dt, tol26 in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        r26 = torch.as_tensor(rng.randn(8, halo26.n_ext_max, 1), dtype=dt, device=dev)

        def per_subdomain(r26=r26):
            z = torch.zeros_like(r26)
            for i, F in enumerate(factors26):
                n_i = int(halo26.ext_sizes[i])
                z[i, :n_i] = blr_solve(F, r26[i, :n_i], user_numbering=True)
            return z

        stacked26[str(dt).removeprefix("torch.")] = dict(
            rel_vs_blr_solve=rel(_blr_local_solve(sf26, r26), per_subdomain()), tol=tol26,
            stacked_ms=event_ms(lambda r26=r26: _blr_local_solve(sf26, r26)),
            per_subdomain_ms=event_ms(per_subdomain))
    del factors26, sf26, gen26, pts_d26
    launches26 = dict(dense=dense_bucket_matvec.launches, lr=lr_bucket_matvec.launches,
                      by_dtype={f"{w.__name__}[{str(dt).removeprefix('torch.')}]": c
                                for w in (dense_bucket_matvec, lr_bucket_matvec)
                                for dt, c in w.launches_by_dtype.items()})
    emit(dict(phase="dist2_n20000", n=n26, partitions=8, epsilon=eps, overlap=0.05, nu=2,
              tol=tol, cells=cells26, stacked_blr_application=stacked26, launches=launches26,
              plain_version_calls=plain26,
              reference_two_level_iterations=ref_iters_2["ras_geneo_additive_2level_20k"],
              phase_s=time.perf_counter() - t_phase))
    runs32, runs64 = cells26["float32"]["runs"], cells26["float64"]["runs"]
    require(all(v["finite"] and v["residual"] < 10 * tol
                for c in cells26.values() for v in c["runs"].values()),
            f"dist2_n20000: residuals {cells26}")
    rep64 = runs64["replicated_two_level"]["iterations"]
    require(all(runs64[f"dist_two_level_{s}"]["iterations"] == rep64
                for s in ("replicated", "local")),
            f"dist2_n20000: float64 two-level iterations against the replicated {rep64}: "
            f"{runs64}")
    require(abs(runs32["dist_one_level_blr"]["iterations"]
                - runs32["dist_one_level_dense"]["iterations"]) <= 2,
            f"dist2_n20000: BLR local solves against dense: {runs32}")
    require(launches26["dense"] > 0 and launches26["lr"] > 0 and plain26 == 0,
            f"dist2_n20000: launches {launches26}, plain calls {plain26}")
    require(all(stacked26[dt]["rel_vs_blr_solve"] <= stacked26[dt]["tol"]
                for dt in ("float32", "float64")),
            f"dist2_n20000: stacked BLR solve against blr_solve {stacked26}")
    torch.cuda.empty_cache()

    # ---------------- 27. the port's bench rows ----------------
    # three rows of torch_bench.py in a subprocess (each row in a process of
    # its own; the kernel library is built by now): every kernel_smoke route
    # must launch its CUDA entry point
    t_phase = time.perf_counter()
    rows27 = ["kernel_smoke", "matvec_n10000", "weak_scaling_static"]
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp27:
        aux27_path = os.path.join(args.out or tmp27, "torch_bench_aux.json")
        bench27 = subprocess.Popen([sys.executable, os.path.join(root, "torch_bench.py"),
                                    "--rows", ",".join(rows27), "--out", aux27_path],
                                   cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True, start_new_session=True)
        try:
            out27, err27 = bench27.communicate(timeout=300)
        finally:  # its row processes are in its session
            if bench27.poll() is None:
                os.killpg(bench27.pid, signal.SIGKILL)
                bench27.wait()
        with open(aux27_path) as f:
            aux27 = json.load(f)
    heads27 = [json.loads(line) for line in out27.splitlines() if line.startswith("{")]
    smoke27 = aux27.get("kernel_smoke", {})
    if heads27:
        emit(heads27[-1])
    emit(dict(phase="torch_bench_rows", rows=rows27, returncode=bench27.returncode,
              violations=aux27.get("violations"), skipped=aux27.get("skipped"),
              kernel_smoke=smoke27, matvec_n10000=aux27.get("matvec_n10000"),
              weak_scaling_static=aux27.get("weak_scaling_static"),
              row_wall_s=aux27.get("row_wall_s"), phase_s=time.perf_counter() - t_phase))
    require(bench27.returncode == 0 and aux27.get("violations") == []
            and aux27.get("skipped") == {} and heads27 and heads27[-1]["value"],
            f"torch_bench rows: rc {bench27.returncode}, violations "
            f"{aux27.get('violations')}, skipped {aux27.get('skipped')}: {err27[-2000:]}")
    require(len(smoke27) == 6 and all(r.get("route") == "cuda" and r.get("launches", 0) > 0
                                      for r in smoke27.values()),
            f"torch_bench kernel_smoke routes without a CUDA launch: {smoke27}")

    # ---------------- 28. several processes: torch_multichip.py ----------------
    # phase 24's configuration (P = 8) over W ranks, each building and holding
    # only its partitions: two gloo ranks sharing this card, then one NCCL
    # rank a card on as many cards as there are (at most 4)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    runs28 = []
    for backend, world in (("gloo", 2), ("nccl", min(4, n_cards))):
        with tempfile.TemporaryDirectory() as tmp28:
            t0 = time.perf_counter()
            mc = subprocess.Popen(
                [sys.executable, os.path.join(root, "torch_multichip.py"), "--world", str(world),
                 "--backend", backend, "--partitions", str(P8), "--n", str(n), "--seed",
                 str(args.seed), "--timeout", "400", "--out", tmp28],
                cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                start_new_session=True)
            try:
                out28, err28 = mc.communicate(timeout=480)
            finally:  # its ranks are in its process group
                if mc.poll() is None:
                    os.killpg(mc.pid, signal.SIGKILL)
                    mc.wait()
            require(mc.returncode == 0, f"torch_multichip.py --world {world} --backend "
                                        f"{backend}: exit {mc.returncode}: {err28[-3000:]}")
            with open(os.path.join(tmp28, "summary.json")) as f:
                summary28 = json.load(f)
            got28 = np.load(os.path.join(tmp28, "gathered.npz"))
            got28 = {key: torch.as_tensor(got28[key]) for key in ("y_N", "y_T", "x")}
        ranks28 = summary28.pop("ranks")
        if args.out:
            with open(os.path.join(args.out, f"torch_multichip_{backend}.json"), "w") as f:
                json.dump(dict(summary28, ranks=ranks28), f)
        run = dict(
            world=world, backend=summary28["backend"], partitions=summary28["partitions"],
            wall_s=time.perf_counter() - t0,
            rel_vs_phase24={key: rel(got28[key], ref28[key]) for key in ("y_N", "y_T")},
            solution_rel_vs_phase24=rel(got28["x"], ref28["x"]),
            iterations=summary28["iterations"], phase24_iterations=ref28["iterations"],
            residual_max=summary28["residual_max"],
            distinct_cards=summary28["distinct_cards"],
            ranks=[dict(rank=r["rank"], card=r["card"], local_partitions=r["local_partitions"],
                        peak_memory_bytes=r["peak_memory_bytes"],
                        product_ms_k8=r["product_ms_k8"], build_s=r["build_s"],
                        setup_s=r["setup_s"], solve_cold_s=r["solve_cold_s"],
                        solve_warm_s=r["solve_warm_s"], lu_shape=r["lu_shape"],
                        launches=r["launches"], plain_version_calls=r["plain_version_calls"],
                        tensors_on_card=r["tensors_on_card"], rank_s=r["rank_s"])
                   for r in ranks28])
        runs28.append(run)
        what = f"torch_multichip.py --world {world} --backend {backend}"
        require(run["backend"] == backend and run["partitions"] == P8 and len(ranks28) == world,
                f"{what}: {summary28}")
        require(max(run["rel_vs_phase24"].values()) <= 1e-6,
                f"{what}: products against phase 24's {run['rel_vs_phase24']}")
        require(run["iterations"] == [ref28["iterations"]] * world
                and run["residual_max"] < 10 * tol,
                f"{what}: iterations {run['iterations']} (phase 24: {ref28['iterations']}), "
                f"residual {run['residual_max']:.3e}")
        for r in ranks28:
            want_card = f"cuda:{r['rank'] if backend == 'nccl' else r['rank'] % n_cards}"
            require(r["card"]["device"] == want_card and r["tensors_on_card"],
                    f"{what}: rank {r['rank']} on {r['card']}, expected {want_card}")
            require(all(v > 0 for v in r["launches"].values())
                    and not r["plain_version_calls"],
                    f"{what}: rank {r['rank']} launches {r['launches']}, plain calls "
                    f"{r['plain_version_calls']}")
        require(backend != "nccl" or world < 2 or run["distinct_cards"],
                f"{what}: ranks share a card: {[r['card'] for r in ranks28]}")
    emit(dict(phase="dist_multiprocess", n=n, partitions=P8, nvidia_smi=smi, cards=n_cards,
              runs=runs28, phase_s=time.perf_counter() - t_phase))

    # ---------------- 29. CG's step from CUDA graphs ----------------
    t_phase = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        emit(dict(phase="cg_graphs", **cg_graphs_check(20_000, dtype, seed=args.seed),
                  phase_s=time.perf_counter() - t_phase))
    emit(dict(phase="wall_time", seconds=time.perf_counter() - t_start))

    # ---------------- the kernels line ----------------
    csrc = "htool_tpu_torch/csrc/"
    # name: (entry point, source, all sources, the TPU kernel's pallas_call)
    sources = {
        "tiled_bucket_matvec": ("htool_stream_matvec", csrc + "stream_matvec.cu",
                                [csrc + "stream_matvec.cu", csrc + "matvec_stream.cuh",
                                 csrc + "matvec_scalar.cuh"],
                                "htool_tpu/ops/tiled_matvec.py:585"),
        SPLIT: ("htool_stream_matvec", csrc + "stream_matvec.cu",
                [csrc + "stream_matvec.cu", csrc + "matvec_stream.cuh", csrc + "matvec_scalar.cuh"],
                "htool_tpu/ops/tiled_matvec.py:215"),
        "dense_bucket_matvec": ("htool_dense_bucket_stream", csrc + "bucket_stream.cu",
                                [csrc + "bucket_stream.cu", csrc + "matvec_stream.cuh",
                                 csrc + "matvec_scalar.cuh"],
                                "htool_tpu/ops/bucket_matvec.py:179"),
        "lr_bucket_matvec": ("htool_lr_bucket_stream", csrc + "bucket_stream.cu",
                             [csrc + "bucket_stream.cu", csrc + "matvec_stream.cuh",
                              csrc + "matvec_scalar.cuh"],
                             "htool_tpu/ops/bucket_matvec.py:258"),
        # a mirror bucket's stored and mirror terms in one launch: the two
        # calls of the same TPU kernel it replaces
        "pair_bucket_matvec": ("htool_pair_matvec", csrc + "pair_matvec.cu",
                               [csrc + "pair_matvec.cu", csrc + "matvec_stream.cuh",
                                csrc + "matvec_scalar.cuh"],
                               "htool_tpu/ops/tiled_matvec.py:585"),
    }
    # the pair pass runs on the main paths of the symmetric stream cells,
    # float32 and complex64 (phase 5c); float64 and complex128 are held to
    # its plain version in phase 5b
    row_dtypes = {"pair_bucket_matvec": (torch.float32, torch.complex64)}

    def bound_of(st, dt):
        by_bytes = 1e3 * st["bytes"] / PEAK_BYTES_S
        by_ops = 1e3 * st["flops"] / PEAK_FLOPS_S[dt]
        return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"

    kernel_rows = []
    for wname, (base, source, all_sources, replaces) in sources.items():
        for dt in row_dtypes.get(wname, DTYPES):
            name = str(dt).removeprefix("torch.")
            st = stats.get((wname, dt))
            n_launch = path_launches.get((wname, dt), 0)
            require(st is not None and st["terms"] > 0 and st["k1"]["terms"] > 0,
                    f"{wname} {name}: no term was timed at k = 8 and k = 1")
            require(n_launch > 0, f"{wname} {name}: not launched on a main path")
            bound_ms, bound_by = bound_of(st, dt)
            k1_bound_ms, k1_bound_by = bound_of(st["k1"], dt)
            if dt.is_complex and wname in ("tiled_bucket_matvec", "pair_bucket_matvec"):
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
