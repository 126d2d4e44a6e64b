#!/usr/bin/env python3
"""Measure the distributed layer's batched passes on one GPU.

    python3 tools/torch_dist_probe.py --phases lu_solve,products,blr --out chiprun_out

Phases (one JSON line each, also appended to ``<out>/torch_dist_probe.jsonl``):

- ``lu_solve``: the dense local mode's solve, ``torch.linalg.lu_solve`` on
  ``[P, n_ext, n_ext]`` float32 LU factors as ``lu_factor`` returns them
  (P = 8, n_ext = 13,073: cell 11a's extended subdomains), against the same
  factors stored row-major and against the two triangular solves after a
  pivot gather; each timed between CUDA events at k = 1 and 8 and traced
  with ``utils.profiling.device_trace``: the device kernels by name, their
  time and count, and the strides of the factors.
- ``products``: the flagship's operator (sphere n = 100,000, float32, leaf
  256, ε = 1e-3, η = 10) on 8 partitions of the card; each product, g2g N
  and T and l2l N at k = 1 and 8, one launch per bucket term over all
  partitions against the per-partition route (each partition's block row
  through ``linalg.matvec``, one launch per term and partition): the
  difference, the times, and the wrapper calls and CUDA launches a product
  (a low-rank term is two CUDA launches).
- ``blr``: cell 6's subdomains (sphere n = 20,000, 8 partitions, overlap
  0.05) factored by BLR (ε 1e-4, block 256), the stacked solve of all 8
  against each subdomain's ``blr_solve`` in float32 and float64 (the
  difference and the times), and the one-level RAS + GMRES solve with BLR
  and with dense local solves.

Every phase needs the card; without one the script exits with 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_log = None


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _log:
        with open(_log, "a") as f:
            f.write(line + "\n")


def event_ms(fn, reps=5):
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def traced_kernels(fn) -> list:
    """[name, ms, count] of the device kernels, memcpys and memsets of one
    call of fn, from ``device_trace``'s Chrome trace, longest first."""
    from htool_tpu_torch.utils.profiling import device_trace

    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            fn()
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    by_name: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ms, c = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (ms + e["dur"] / 1e3, c + 1)
    return [[n[:96], ms, c] for n, (ms, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])]


def rel(a, b) -> float:
    import torch

    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


def phase_lu_solve(dev, P=8, n=13_073):
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((P, n, n), generator=g, device=dev)
    LU, piv = torch.linalg.lu_factor(A)
    del A
    torch.cuda.empty_cache()
    LU_rows = LU.contiguous()  # the same factors, row-major
    # the pivots as one gather of the rows: LAPACK's 1-based sequential swaps
    swaps = piv.cpu().numpy() - 1
    perm = np.tile(np.arange(n), (P, 1))
    for p in range(P):
        for i, j in enumerate(swaps[p]):
            perm[p, [i, j]] = perm[p, [j, i]]
    perm = torch.as_tensor(perm, device=dev)

    def triangular_pair(B):
        y = torch.gather(B, 1, perm[:, :, None].expand(-1, -1, B.shape[2]))
        y = torch.linalg.solve_triangular(LU, y, upper=False, unitriangular=True)
        return torch.linalg.solve_triangular(LU, y, upper=True)

    variants = {
        "lu_solve_as_factored": lambda B: torch.linalg.lu_solve(LU, piv, B),
        "lu_solve_row_major": lambda B: torch.linalg.lu_solve(LU_rows, piv, B),
        "triangular_pair": triangular_pair,
    }
    out = dict(phase="lu_solve", P=P, n_ext=n, dtype="float32",
               factor_bytes=LU.numel() * LU.element_size(),
               strides=dict(as_factored=list(LU.stride()), row_major=list(LU_rows.stride())),
               as_factored_mT_contiguous=bool(LU.mT.is_contiguous()), variants={})
    for k in (1, 8):
        B = torch.randn((P, n, k), generator=g, device=dev)
        want = torch.linalg.lu_solve(LU, piv, B)
        for name, fn in variants.items():
            out["variants"][f"{name}/k{k}"] = dict(
                ms=event_ms(lambda: fn(B)), rel_vs_as_factored=rel(fn(B), want),
                kernels=traced_kernels(lambda: fn(B))[:6])
    emit(out)


def phase_products(dev, seed, n=100_000):
    import torch

    import htool_tpu_torch as ht
    from htool_tpu_torch.hmatrix import linalg
    from htool_tpu_torch.ops.bucket_matvec import dense_bucket_matvec, lr_bucket_matvec
    from htool_tpu_torch.parallel import build_distributed_hmatrix, default_mesh
    from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

    P = 8
    pts = create_sphere(n, seed=seed)
    pts_d = torch.as_tensor(pts.astype(np.float32), device=dev)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts_d, pts_d)
    tree = ht.build_cluster_tree(pts, max_leaf_size=256, n_partitions=P)
    D = build_distributed_hmatrix(gen, tree, default_mesh(P, device=dev), epsilon=1e-3, eta=10.0)
    perm = torch.as_tensor(tree.permutation, device=dev)
    m = D.m_loc_max

    def per_partition(xc, op):
        """Each partition's block row through linalg.matvec: one launch per
        bucket term and partition (the route before the folding)."""
        if op == "N":
            return torch.cat([linalg.matvec(D._local(i), xc, "N") for i in range(P)])
        xs = D.to_local_layout(xc).reshape(P, m, -1)
        return sum(linalg.matvec(D._local(i), xs[i], op) for i in range(P))

    def launches(fn):
        """[wrapper calls, CUDA launches] of one product."""
        wrappers = (dense_bucket_matvec, lr_bucket_matvec)
        for w in wrappers:
            w.launches = w.cuda_launches = 0
        fn()
        torch.cuda.synchronize()
        return [sum(w.launches for w in wrappers), sum(w.cuda_launches for w in wrappers)]

    rng = np.random.RandomState(seed)
    out = dict(phase="products", n=n, partitions=P, m_loc_max=m,
               bucket_terms={op: sum(len(linalg._bucket_terms(b, op, D.symmetry))
                                     for b in D.dense_buckets + D.lr_buckets)
                             for op in ("N", "T")},
               products={})
    for k in (1, 8):
        x = torch.as_tensor(rng.randn(n, k).astype(np.float32), device=dev)
        xc = x[perm]
        x_loc = D.to_local_layout(xc)
        for op in ("N", "T"):
            folded = lambda op=op: D._product(xc if op == "N" else x_loc, op)  # noqa: E731
            parts = lambda op=op: per_partition(xc, op)  # noqa: E731
            out["products"][f"{op}/k{k}"] = dict(
                folded_ms=event_ms(folded), per_partition_ms=event_ms(parts),
                folded_launches=launches(folded), per_partition_launches=launches(parts),
                rel_folded_vs_per_partition=rel(folded(), parts()),
                g2g_ms=event_ms(lambda op=op: D.matvec(x, op=op)))
        out["products"][f"l2l_N/k{k}"] = dict(l2l_ms=event_ms(lambda: D.matvec_local(x_loc)))
    out.update(n_dense_buckets=len(D.dense_buckets), n_lr_buckets=len(D.lr_buckets))
    emit(out)


def phase_blr(dev, seed, n=20_000):
    import torch

    import htool_tpu_torch as ht
    from htool_tpu_torch.hmatrix.blr import blr_solve
    from htool_tpu_torch.parallel import build_distributed_hmatrix, default_mesh
    from htool_tpu_torch.solvers import DistributedDDMSolver, build_geometric_overlap
    from htool_tpu_torch.solvers.dist_ddm import (
        _blr_local_solve,
        _stack_blr_factors,
        _subdomain_blr_factors,
        build_halo_exchange,
    )
    from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

    P = 8
    pts = create_sphere(n, seed=seed)
    pts_d = torch.as_tensor(pts.astype(np.float32), device=dev)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts_d, pts_d)
    tree = ht.build_cluster_tree(pts, max_leaf_size=256, n_partitions=P)
    ov = build_geometric_overlap(tree, 0.05)
    halo = build_halo_exchange(tree, ov)
    t0 = time.perf_counter()
    factors = _subdomain_blr_factors(gen, tree, ov, range(P), 1e-4, 256)
    torch.cuda.synchronize()
    t_factor = time.perf_counter() - t0
    t0 = time.perf_counter()
    sf = _stack_blr_factors(factors, halo.n_ext_max, dev)
    torch.cuda.synchronize()
    out = dict(phase="blr", n=n, partitions=P, factor_s=t_factor,
               stack_s=time.perf_counter() - t0, B=sf.B, nL=sf.nL, Rh=sf.Rh,
               per_subdomain=[dict(b=F.b, nL=F.nL, R_half=F.R_half) for F in factors],
               n_ext_max=halo.n_ext_max, applications={})
    rng = np.random.RandomState(seed)
    for dtype in (torch.float32, torch.float64):
        r = torch.as_tensor(rng.randn(P, halo.n_ext_max, 1), dtype=dtype, device=dev)

        def loop():
            z = torch.zeros_like(r)
            for i, F in enumerate(factors):
                n_i = int(halo.ext_sizes[i])
                z[i, :n_i] = blr_solve(F, r[i, :n_i], user_numbering=True)
            return z

        out["applications"][str(dtype).removeprefix("torch.")] = dict(
            rel_stacked_vs_blr_solve=rel(_blr_local_solve(sf, r), loop()),
            stacked_ms=event_ms(lambda: _blr_local_solve(sf, r)), per_subdomain_ms=event_ms(loop))
    D = build_distributed_hmatrix(gen, tree, default_mesh(P, device=dev), epsilon=1e-3,
                                  eta=10.0)
    b = D @ torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
    out["solves"] = {}
    for name, kw in (("dense", {}), ("blr", dict(local_solver="blr", blr_epsilon=1e-4,
                                                  blr_block_size=256))):
        t0 = time.perf_counter()
        s = DistributedDDMSolver(D, gen, tree, schwarz="ras", overlap=ov, **kw)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            _, it = s.solve(b, tol=1e-6, krylov="gmres", restart=60, maxiter=200)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["solves"][name] = dict(setup_s=setup, solve_cold_s=times[0], solve_warm_s=times[1],
                                   iterations=it["Nb_it"], residual=it["Residual"])
    emit(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="lu_solve,products,blr")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="directory for torch_dist_probe.jsonl")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_dist_probe: no CUDA device", file=sys.stderr)
        return 2
    global _log
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        _log = os.path.join(args.out, "torch_dist_probe.jsonl")
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit(dict(phase="device", kind=torch.cuda.get_device_name(0), nvidia_smi=smi.strip(),
              torch=torch.__version__, cuda=torch.version.cuda))
    dev = torch.device("cuda", 0)
    phases = dict(lu_solve=lambda: phase_lu_solve(dev),
                  products=lambda: phase_products(dev, args.seed),
                  blr=lambda: phase_blr(dev, args.seed))
    for name in args.phases.split(","):
        t0 = time.perf_counter()
        phases[name]()
        emit(dict(phase=f"{name}_done", seconds=time.perf_counter() - t0))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
