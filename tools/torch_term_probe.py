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
events over ``--reps`` launches.  A mirror bucket gets both its per-term
launches (its stored and its mirror term, as before the pair pass) and its
pair launch (term "pair": both in one launch, ``live_mb`` what it fetches,
its cluster size ``cs`` and items a CTA ``G``).  The table is made at k = 1
in float32, then, with the operator cast to complex64 times (1 + i) (the
complex cell's kernel has the same ranks), at k = 8; after each, the whole
product with the pair plans (``plans: "pair"``) and with per-term plans on
every bucket (``plans: "per_term"``), in turns.  ``--sweep`` also times each
pair launch at every cluster size and number of items a CTA (rows
``sweep`` in the output file, ``sweep_best``), and a dense one cut with
other tile budgets (``sweep_tiles``).

    python3 tools/torch_term_probe.py [--n 100000] [--seed 0] [--reps 50] [--out DIR] [--sweep]
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
    ap.add_argument("--sweep", action="store_true",
                    help="time each pair launch at every layout and G that fits")
    args = ap.parse_args(argv)

    import torch

    import htool_tpu_torch as ht
    from htool_tpu_torch.hmatrix.linalg import _pad_in_of, matvec, prepare_tiled_matvec
    from htool_tpu_torch.ops import pair_matvec as pm
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

    out_len = H.shape[0] + _pad_in_of(H)

    def per_term(bucket):
        """The bucket's per-term plans (stored, mirror), as before the pair pass."""
        if bucket.pair is None:
            return bucket.plan_t, bucket.plan_s
        build = tm.build_tile_plan if isinstance(bucket, ht.DenseBucket) else \
            tm.build_tile_plan_lr_split
        return build(bucket, "t", out_len), build(bucket, "s", out_len)

    def table(k):
        """One row per launch of the product at k columns, per-term and pair,
        in the operator's dtype; then their sums."""
        sums = dict(stored_mb=0.0, live_mb=0.0, us=0.0, pair_live_mb=0.0, pair_us=0.0,
                    pair_terms_us=0.0)
        for bi, bucket in enumerate(H.dense_buckets + H.lr_buckets):
            dense = isinstance(bucket, ht.DenseBucket)
            item = (bucket.data if dense else bucket.U).element_size()
            ranks = None if dense else np.asarray(bucket.ranks)
            head = dict(bucket=bi, kind="dense" if dense else "lr", mirror=bool(bucket.mirror),
                        dtype=str((bucket.data if dense else bucket.U).dtype), k=k,
                        n_blocks=bucket.n_blocks, block_shape=list(bucket.block_shape),
                        padded_rank=None if dense else bucket.rank_padded,
                        rank_median=None if dense else float(np.median(ranks)),
                        rank_max=None if dense else int(ranks.max()))
            plan_t, plan_s = per_term(bucket)
            terms = [("stored", plan_t)] + ([("mirror", plan_s)] if bucket.mirror else [])
            terms_us = 0.0
            for term, plan in terms:
                if isinstance(plan, tm.SplitPlan):
                    first, second = ("V", "U") if term == "stored" else ("U", "V")
                    stages = [("A", plan.stage_a, first, True),
                              ("B", plan.stage_b, second, False)]
                    mid = torch.zeros((plan.t_len, k), dtype=plan.dtype, device=dev)
                else:
                    stages = [("-", plan, "data", False)]
                    mid = None
                for name, st, which, store in stages:
                    mat = getattr(bucket, which)
                    stored = mat.numel() * mat.element_size()
                    live = live_bytes(*live_extent(bucket, which), item)
                    row = dict(phase="term", **head, term=term, stage=name, matrix=which,
                               P=int(st.P), cut=int(st.out_w), G=int(st.G),
                               n_steps=int(st.n_steps), stored_mb=stored / 1e6,
                               live_mb=live / 1e6)
                    if cuda:
                        if name == "A":
                            x = torch.randn((st.in_end, k), dtype=st.dtype, device=dev)
                            y = mid
                        elif name == "B":
                            x, y = mid, torch.zeros((st.out_len, k), dtype=st.dtype, device=dev)
                        else:
                            x = torch.randn((st.in_end, k), dtype=st.dtype, device=dev)
                            y = torch.zeros((st.out_len, k), dtype=st.dtype, device=dev)
                        row["us"] = event_us(lambda: tm._launch(st, x, y, False, store))
                        sums["us"] += row["us"]
                        terms_us += row["us"]
                    sums["stored_mb"] += row["stored_mb"]
                    sums["live_mb"] += row["live_mb"]
                    emit(row)
            pair = bucket.pair
            if pair is not None:
                ints, read = pm._geometry(pair, pm._kc(k))
                geom = dict(zip(pm._GEOM, ints))
                row = dict(phase="term", **head, term="pair", stage="-", n_items=pair.n_items,
                           cs=geom["cs"], G=geom["G"], smem=geom["smem"],
                           live_mb=read / 1e6)
                if cuda:
                    x = torch.randn((out_len, k), dtype=pair.dtype, device=dev)
                    y = torch.zeros((out_len, k), dtype=pair.dtype, device=dev)
                    row["us"] = event_us(lambda: pm.pair_bucket_matvec(pair, x, out=y))
                    row["per_term_us"] = terms_us
                    sums["pair_us"] += row["us"]
                    sums["pair_terms_us"] += terms_us
                    if args.sweep:
                        sweep(pair, x, y, head)
                        if pair.kind == "dense":
                            sweep_tiles(bucket, x, y, head)
                sums["pair_live_mb"] += row["live_mb"]
                emit(row)
        emit(dict(phase="term_sums", k=k, **sums))

    def sweep(pair, x, y, head):
        """The pair launch at every cluster size that fits and every number
        of items a CTA, against the rule's pick."""
        KC = pm._kc(x.shape[1])
        item = pair.data.element_size()
        best = None
        for cs in (1, 2, 4, 8) if pair.kind == "lr" else (1,):
            if pm._layout(pair, KC, item, cs)["smem"] > pm._SMEM_MAX:
                continue
            ints, read = pm._laid_out(pair, KC, cs)
            for G in (1, 2, 4, 8, 16, 32):
                g = list(ints)
                g[pm._GEOM.index("G")] = G
                pair.__dict__["_geom"] = {KC: (tuple(g), read)}
                pair.__dict__.pop("_args", None)
                us = event_us(lambda: pm.pair_bucket_matvec(pair, x, out=y), reps=10)
                if log:
                    log.write(json.dumps(dict(phase="sweep", bucket=head["bucket"],
                                              dtype=head["dtype"], k=head["k"], cs=cs, G=G,
                                              us=us)) + "\n")
                if best is None or us < best[0]:
                    best = (us, cs, G)
        pair.__dict__.pop("_geom", None)
        pair.__dict__.pop("_args", None)
        emit(dict(phase="sweep_best", bucket=head["bucket"], dtype=head["dtype"], k=head["k"],
                  us=best[0], cs=best[1], G=best[2]))

    def sweep_tiles(bucket, x, y, head):
        """A dense pair plan cut with other tile budgets, at the rule's G."""
        kept = pm._TILE_BYTES
        try:
            for tb in (24, 40, 56, 72, 96):
                pm._TILE_BYTES = tb * 1024
                plan = pm.build_pair_plan(bucket, out_len)
                if plan is None:
                    continue
                geom = dict(zip(pm._GEOM, pm._geometry(plan, pm._kc(x.shape[1]))[0]))
                emit(dict(phase="sweep_tiles", bucket=head["bucket"], dtype=head["dtype"],
                          k=head["k"], tile_kb=tb, tile_rows=plan.tile_rows, G=geom["G"],
                          smem=geom["smem"], us=event_us(
                              lambda: pm.pair_bucket_matvec(plan, x, out=y), reps=20)))
        finally:
            pm._TILE_BYTES = kept

    table(1)

    def products(dtype, k, reps):
        """The whole product with the pair plans and with per-term plans on
        every bucket, in turns (pair, per-term, per-term, pair)."""
        n = H.shape[1]
        x = torch.randn((n, k), dtype=dtype, device=dev)
        pairs = [(b, b.pair) for b in H.dense_buckets + H.lr_buckets]
        terms = [per_term(b) for b, _ in pairs]

        def use(which):
            for (b, p), pt in zip(pairs, terms):
                b.pair = p if which == "pair" else None
                b.plan_t, b.plan_s = (None, None) if b.pair is not None else pt

        for which in ("pair", "per_term", "per_term", "pair"):
            use(which)
            launches = pm.pair_bucket_matvec.cuda_launches + tm.tiled_bucket_matvec.cuda_launches
            matvec(H, x)
            launches = (pm.pair_bucket_matvec.cuda_launches
                        + tm.tiled_bucket_matvec.cuda_launches - launches)
            emit(dict(phase="product", dtype=str(dtype).removeprefix("torch."), k=k,
                      plans=which, launches=launches, us=event_us(lambda: matvec(H, x), reps=reps)))
        use("pair")

    if cuda:
        products(torch.float32, 1, max(20, args.reps))
        one_i = torch.tensor(1 + 1j, dtype=torch.complex64, device=dev)
        for b in H.dense_buckets:
            b.data = b.data.to(torch.complex64) * one_i
        for b in H.lr_buckets:
            b.U = b.U.to(torch.complex64) * one_i
            b.V = b.V.to(torch.complex64)
        prepare_tiled_matvec(H)
        table(8)
        products(torch.complex64, 8, 20)
    if log:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
