#!/usr/bin/env python3
"""Per-term table of the symmetric product on the benchmark's sphere.

Builds the operator of ``benchmark/configs/sphere_laplace_f32_n100k.json``
(n points on the unit sphere, 1/(1e-5 + 4π‖x − y‖) in float32, leaf 100,
64 partitions, ε 1e-3, η 100, 'S', 'L', planned products) and prints one
JSON line per launch of its planned product: the bucket, the term (stored
or mirror) and stage, the plan's cut, the bytes the padded storage holds
for the launch's matrices, the bytes of their live extent (each block's
true rows, columns and rank, each row's run rounded up to 32-byte
sectors), and, on a CUDA device, the launch's mean time between two CUDA
events over ``--reps`` launches.  Then the whole product at k = 1 in
float32 and, with the operator cast to complex64 times (1 + i) (the
complex cell's kernel has the same ranks), at k = 8.

    python3 tools/torch_term_probe.py [--n 100000] [--seed 0] [--reps 50] [--out DIR]
    python3 tools/torch_term_probe.py --device cpu --n 3000     (the table, no times)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_SECTOR = 32


def live_bytes(rows, cols, item: int) -> int:
    """Bytes of row-major blocks read at their live extent: rows[b] rows of
    cols[b] entries each, every row's run rounded up to 32-byte sectors."""
    rows = np.asarray(rows, np.int64)
    run = -(-np.asarray(cols, np.int64) * item // _SECTOR) * _SECTOR
    return int(np.sum(rows * run))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import htool_tpu_torch as ht
    from htool_tpu_torch.hmatrix.linalg import matvec, prepare_tiled_matvec
    from htool_tpu_torch.ops import tiled_matvec as tm
    from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    log = open(os.path.join(args.out, "torch_term_probe.jsonl"), "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if log:
            log.write(line + "\n")
            log.flush()

    if cuda:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
        emit(dict(phase="device", nvidia_smi=smi[0] if smi else None, torch=torch.__version__,
                  cuda=torch.version.cuda))

    t0 = time.perf_counter()
    pts = create_sphere(args.n, seed=args.seed)
    pts_d = torch.as_tensor(pts.astype(np.float32), device=dev)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts_d, pts_d)
    tree = ht.build_cluster_tree(pts, max_leaf_size=100, n_partitions=64)
    H = ht.build_hmatrix(gen, tree, epsilon=1e-3, eta=100.0, symmetry="S", UPLO="L")
    prepare_tiled_matvec(H)
    if cuda:
        torch.cuda.synchronize()
    emit(dict(phase="build", n=args.n, seconds=time.perf_counter() - t0))

    def event_us(fn, reps=args.reps):
        fn()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return 1e3 * e0.elapsed_time(e1) / reps

    def live_extent(bucket, which):
        """(rows, cols) per block, at the live extent, of the matrix a launch
        streams: a dense block, U or V."""
        t, s = np.asarray(bucket.t_sizes), np.asarray(bucket.s_sizes)
        if which == "data":
            return t, s
        r = np.asarray(bucket.ranks)
        return (t, r) if which == "U" else (r, s)

    sums = dict(stored_mb=0.0, live_mb=0.0, us=0.0)
    for bi, bucket in enumerate(H.dense_buckets + H.lr_buckets):
        dense = isinstance(bucket, ht.DenseBucket)
        item = (bucket.data if dense else bucket.U).element_size()
        ranks = None if dense else np.asarray(bucket.ranks)
        head = dict(bucket=bi, kind="dense" if dense else "lr", mirror=bool(bucket.mirror),
                    n_blocks=bucket.n_blocks, block_shape=list(bucket.block_shape),
                    padded_rank=None if dense else bucket.rank_padded,
                    rank_median=None if dense else float(np.median(ranks)),
                    rank_max=None if dense else int(ranks.max()))
        terms = [("stored", bucket.plan_t)] + ([("mirror", bucket.plan_s)] if bucket.mirror else [])
        for term, plan in terms:
            if isinstance(plan, tm.SplitPlan):
                first, second = ("V", "U") if term == "stored" else ("U", "V")
                stages = [("A", plan.stage_a, first, True), ("B", plan.stage_b, second, False)]
                mid = torch.zeros((plan.t_len, 1), dtype=plan.dtype, device=dev)
            else:
                stages = [("-", plan, "data", False)]
                mid = None
            for name, st, which, store in stages:
                mat = getattr(bucket, which)
                stored = mat.numel() * mat.element_size()
                live = live_bytes(*live_extent(bucket, which), item)
                row = dict(phase="term", **head, term=term, stage=name, matrix=which,
                           P=int(st.P), cut=int(st.out_w), G=int(st.G), n_steps=int(st.n_steps),
                           stored_mb=stored / 1e6, live_mb=live / 1e6)
                if cuda:
                    if name == "A":
                        x = torch.randn((st.in_end, 1), dtype=st.dtype, device=dev)
                        y = mid
                    elif name == "B":
                        x, y = mid, torch.zeros((st.out_len, 1), dtype=st.dtype, device=dev)
                    else:
                        x = torch.randn((st.in_end, 1), dtype=st.dtype, device=dev)
                        y = torch.zeros((st.out_len, 1), dtype=st.dtype, device=dev)
                    row["us"] = event_us(lambda: tm._launch(st, x, y, False, store))
                    sums["us"] += row["us"]
                sums["stored_mb"] += row["stored_mb"]
                sums["live_mb"] += row["live_mb"]
                emit(row)
    emit(dict(phase="term_sums", **sums))

    if cuda:
        n = H.shape[1]
        x1 = torch.randn((n, 1), dtype=torch.float32, device=dev)
        emit(dict(phase="product", dtype="float32", k=1,
                  us=event_us(lambda: matvec(H, x1), reps=max(20, args.reps))))
        one_i = torch.tensor(1 + 1j, dtype=torch.complex64, device=dev)
        for b in H.dense_buckets:
            b.data = b.data.to(torch.complex64) * one_i
        for b in H.lr_buckets:
            b.U = b.U.to(torch.complex64) * one_i
            b.V = b.V.to(torch.complex64)
        prepare_tiled_matvec(H)
        x8 = torch.randn((n, 8), dtype=torch.complex64, device=dev)
        emit(dict(phase="product", dtype="complex64", k=8,
                  us=event_us(lambda: matvec(H, x8), reps=20)))
    if log:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
