#!/usr/bin/env python3
"""Probe the port's product kernels on one NVIDIA GPU: build, check, time.

Run from the root of a checkout on a machine with a Hopper GPU:

    python3 tools/torch_kernel_probe.py [--n 100000] [--out out_dir] [--phases check,real,...]
    python3 tools/torch_kernel_probe.py --fit out_dir/torch_kernel_probe.jsonl   (no GPU)

Phases (each prints JSON lines; with ``--out`` they are also written to
``torch_kernel_probe.jsonl`` there):

- ``build``: compile the kernels, print ptxas' registers and spills;
- ``check``: every route of the streaming kernels (dense plans, one-launch
  and split low-rank plans, unplanned dense terms, one-launch and two-stage
  unplanned low-rank terms) against its plain version, on small random
  buckets (float64 and complex128 at k >= 4 on the FP64 tensor cores): 4 dtypes, both
  orientations, conj, k = 1, 2, 3, 5, 8, 11, aligned and unaligned shapes;
- ``real``: the real flagship H-matrix (n points on a sphere, f32, leaf 256,
  64 partitions): per bucket and k = 1, 8, the streaming kernel on the dense
  bucket and each low-rank bucket one-launch against split; the same
  buckets cast to complex64, float64 and complex128;
- ``wide``: random complex64 low-rank buckets of the hermitian path's
  shapes, unplanned: one-launch against two-stage, with the ``torch.bmm``
  yardstick;
- ``rule``: one launch against two stages, planned and unplanned, on random
  low-rank buckets as the bytes of a block (1 KB - 400 KB) and of the whole
  bucket (256 KB - 64 MB) vary, at k = 1 and 8: the time per call in a loop
  of calls (the host's pace where the launch is shorter than a call) and the
  kernels' own durations from a profiler trace; the measurements behind
  ``ops/cut.py::lr_split_wanted``;
- ``product``: the symmetric unplanned product, host enqueue time against
  the whole, with the rule, all one-launch and all two-stage;
- ``devtime``: kernel durations of the symmetric path's terms from a
  profiler trace;
- ``target``: the real flagship's and the wide buckets' times as the byte
  target of the cut rule varies;
- ``floor``: what one wrapper call costs on a bucket of one tiny block, on
  the host clock over 1,000 calls and with CUDA events.

Every time is the mean of ``--reps`` launches between two CUDA events after
one warm-up launch.
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_log = None


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    if _log:
        with open(_log, "a") as f:
            f.write(line + "\n")


def rule_regret(path: str) -> None:
    """From the ``rule`` rows of an earlier run's JSON lines (no GPU needed):
    the mean microseconds a term loses against the faster of its two routes,
    by the kernels' own durations and by the time per call in a loop, when
    every term takes one launch, when every term takes two stages, and under
    ``ops/cut.py::lr_split_wanted``."""
    from htool_tpu_torch.ops.cut import lr_split_wanted

    rows = [r for r in map(json.loads, open(path)) if r.get("phase") == "rule"]
    item = {"torch.float32": 4, "torch.complex64": 8, "torch.complex128": 16}
    choices = {"one_launch": lambda r, k: False, "two_stages": lambda r, k: True,
               "rule": lambda r, k: lr_split_wanted(r["nb"], r["bm"], r["bm"], r["r"],
                                                    item[r["dtype"]], k)}
    for one, two, knows_k in (("planned_one", "planned_split", False),
                              ("unplanned_one", "unplanned_two", True)):
        for k in (1, 8):
            out = {}
            for name, choose in choices.items():
                lost = {"_dev_us": [], "_us": []}
                for r in rows:
                    if r["k"] != k or min(r[one + "_dev_us"], r[two + "_dev_us"]) <= 0:
                        continue  # a trace that missed the launches
                    took = two if choose(r, k if knows_k else None) else one
                    for sfx, acc in lost.items():
                        acc.append(r[took + sfx] - min(r[one + sfx], r[two + sfx]))
                out[name] = dict(device_us=sum(lost["_dev_us"]) / len(lost["_dev_us"]),
                                 per_call_us=sum(lost["_us"]) / len(lost["_us"]))
            emit(dict(phase="rule_regret", routes=one.split("_")[0], k=k,
                      cases=len(lost["_us"]), mean_loss=out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fit", default=None, metavar="JSONL",
                    help="score lr_split_wanted on the rule rows of an earlier run and exit")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--phases", default="build,check,real,wide,target,floor")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if args.fit:
        rule_regret(args.fit)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.out:
        global _log
        os.makedirs(args.out, exist_ok=True)
        _log = os.path.join(args.out, "torch_kernel_probe.jsonl")
        open(_log, "w").close()

    import htool_tpu_torch as ht
    from htool_tpu_torch import kernels
    from htool_tpu_torch.hmatrix.linalg import _pad_in_of
    from htool_tpu_torch.ops import cut as cut_mod
    from htool_tpu_torch.ops import tiled_matvec as tiled_ops
    from htool_tpu_torch.ops.bucket_matvec import (
        dense_bucket_matvec,
        dense_bucket_matvec_reference,
        lr_bucket_matvec,
        lr_bucket_matvec_reference,
    )
    from htool_tpu_torch.ops.tiled_matvec import (
        build_tile_plan,
        build_tile_plan_lr_split,
        tiled_bucket_matvec,
        tiled_bucket_matvec_reference,
    )
    from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda))
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def event_ms(fn, reps=args.reps):
        fn()
        ev0.record()
        for _ in range(reps):
            fn()
        ev1.record()
        sync()
        return ev0.elapsed_time(ev1) / reps

    kernels.load_library()
    if "build" in phases:
        emit(dict(phase="build", seconds=kernels.build_info["seconds"],
                  ptxas=[l.strip() for l in kernels.build_info["ptxas"].splitlines()
                         if "registers" in l or "spill" in l or "Compiling" in l]))

    gen_r = torch.Generator(device=dev).manual_seed(0)
    TOL = {torch.float32: 1e-5, torch.complex64: 1e-5, torch.float64: 1e-12,
           torch.complex128: 1e-12}

    def randn(*shape, dtype):
        return torch.randn(shape, dtype=dtype, device=dev, generator=gen_r)

    def rand_bucket(kind, nb, bm, bn, r, dtype, L):
        offs = dict(t_off=torch.randint(0, L - bm, (nb,), device=dev, generator=gen_r),
                    s_off=torch.randint(0, L - bn, (nb,), device=dev, generator=gen_r))
        if kind == "dense":
            return ht.DenseBucket(data=randn(nb, bm, bn, dtype=dtype), **offs)
        return ht.LowRankBucket(U=randn(nb, bm, r, dtype=dtype) / r ** 0.5,
                                V=randn(nb, r, bn, dtype=dtype), **offs)

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp_min(1e-300))

    def unplanned(bucket, xp, trans, L, conj=False, split=None, plain=False):
        in_off, out_off = ((bucket.t_off, bucket.s_off) if trans
                           else (bucket.s_off, bucket.t_off))
        if isinstance(bucket, ht.DenseBucket):
            fn = dense_bucket_matvec_reference if plain else dense_bucket_matvec
            return fn(bucket.data, in_off, out_off, xp, trans, L, conj=conj)
        if plain:
            return lr_bucket_matvec_reference(bucket.U, bucket.V, in_off, out_off, xp, trans, L,
                                              conj=conj)
        return lr_bucket_matvec(bucket.U, bucket.V, in_off, out_off, xp, trans, L, conj=conj,
                                split=split)

    # ---------------- check ----------------
    if "check" in phases:
        L = 6000
        shapes = [("dense", 6, 224, 224, 0), ("dense", 5, 37, 101, 0), ("dense", 3, 416, 1568, 0),
                  ("dense", 2, 300, 3, 0), ("dense", 7, 1, 1, 0), ("dense", 40, 256, 256, 0),
                  ("dense", 9, 33, 70, 0), ("dense", 200, 224, 224, 0),
                  ("lr", 6, 224, 224, 16), ("lr", 3, 1568, 1568, 16), ("lr", 2, 1000, 700, 99),
                  ("lr", 3, 333, 517, 1), ("lr", 2, 800, 800, 256), ("lr", 1, 3136, 2080, 130),
                  ("lr", 4, 61, 45, 7)]
        worst, n_cases, failed = {}, 0, {}
        for kind, nb, bm, bn, r in shapes:
            for dtype in TOL:
                bucket = rand_bucket(kind, nb, bm, bn, r, dtype, L)
                for side in ("t", "s"):
                    trans = side == "s"
                    routes = {"plan": build_tile_plan(bucket, side, L)}
                    if kind == "lr":
                        routes["split"] = build_tile_plan_lr_split(bucket, side, L)
                    for conj in ((False, True) if dtype.is_complex else (False,)):
                        for k in (1, 2, 3, 5, 8, 11):
                            xp = randn(L, k, dtype=dtype)
                            ref = tiled_bucket_matvec_reference(routes["plan"], xp, conj=conj)
                            got = {name: tiled_bucket_matvec(pl, xp, conj=conj)
                                   for name, pl in routes.items()}
                            if kind == "lr":
                                got["unplanned_one"] = unplanned(bucket, xp, trans, L, conj, False)
                                got["unplanned_two"] = unplanned(bucket, xp, trans, L, conj, True)
                            else:
                                got["unplanned"] = unplanned(bucket, xp, trans, L, conj)
                            sync()
                            for name, y in got.items():
                                e = rel(y, ref)
                                key = f"{kind}/{name}/{str(dtype)[6:]}"
                                worst[key] = max(worst.get(key, 0.0), e)
                                n_cases += 1
                                if not (e <= TOL[dtype]) or not bool(torch.isfinite(y).all()):
                                    failed.setdefault(key, dict(
                                        route=name, kind=kind, nb=nb, bm=bm, bn=bn, r=r,
                                        dtype=str(dtype), side=side, conj=conj, k=k, rel=e))
                del bucket
        # a misaligned view of the block data: the element-wise copy path
        base = randn(3 * 64 * 64 + 1, dtype=torch.float32)
        odd = ht.DenseBucket(data=base[1:].view(3, 64, 64),
                             t_off=torch.tensor([0, 100, 200], device=dev),
                             s_off=torch.tensor([50, 0, 300], device=dev))
        for side in ("t", "s"):
            pl = build_tile_plan(odd, side, 500)
            xp = randn(500, 8, dtype=torch.float32)
            e = rel(tiled_bucket_matvec(pl, xp), tiled_bucket_matvec_reference(pl, xp))
            worst[f"dense/misaligned/{side}"] = e
            if not e <= 1e-5:
                emit(dict(phase="check", failed=dict(route="misaligned", side=side, rel=e)))
                return 1
        emit(dict(phase="check", cases=n_cases, worst_rel=worst, failed=failed))
        if failed:
            return 1

    # ---------------- real flagship buckets ----------------
    H = None
    if phases & {"real", "target"}:
        n = args.n
        pts = create_sphere(n, seed=0)
        pts_d = torch.as_tensor(pts.astype(np.float32), device=dev)
        gen = ht.KernelGenerator(laplace_kernel_symmetric, pts_d, pts_d)
        tree = ht.build_cluster_tree(pts, max_leaf_size=256, n_partitions=64)
        H = ht.build_hmatrix(gen, tree, epsilon=1e-3, eta=10.0)
        sync()
        m_pad = H.shape[0] + _pad_in_of(H)
        buckets = H.dense_buckets + H.lr_buckets

    def cast(bucket, dtype):
        if isinstance(bucket, ht.DenseBucket):
            return dataclasses.replace(bucket, data=bucket.data.to(dtype))
        return dataclasses.replace(bucket, U=bucket.U.to(dtype), V=bucket.V.to(dtype))

    def bucket_bytes(b):
        t = [b.data] if isinstance(b, ht.DenseBucket) else [b.U, b.V]
        return sum(x.numel() * x.element_size() for x in t)

    def time_planned(bucket, side, L, k, dtype):
        """ms of the routes of one planned term."""
        xp = randn(L, k, dtype=dtype)
        out = {}
        if isinstance(bucket, ht.DenseBucket):
            pn = build_tile_plan(bucket, side, L)
            out["stream"] = event_ms(lambda: tiled_bucket_matvec(pn, xp))
            out["cut"] = [pn.P, pn.out_w, pn.G, pn.n_steps]
        else:
            p1, p2 = build_tile_plan(bucket, side, L), build_tile_plan_lr_split(bucket, side, L)
            out["one_launch"] = event_ms(lambda: tiled_bucket_matvec(p1, xp))
            out["split"] = event_ms(lambda: tiled_bucket_matvec(p2, xp))
            out["cut"] = [[p.P, p.out_w, p.G, p.n_steps] for p in p2]
        return out

    if "real" in phases:
        for dtype in (torch.float32, torch.complex64, torch.float64, torch.complex128):
            sums = {}
            for bi, b0 in enumerate(buckets):
                b = cast(b0, dtype)
                for k in (1, 8):
                    if dtype in (torch.float64, torch.complex128) and k == 1:
                        continue
                    r = time_planned(b, "t", m_pad, k, dtype)
                    item = torch.empty((), dtype=dtype).element_size()
                    bound = (bucket_bytes(b) + 2 * m_pad * k * item) / 3.35e9
                    emit(dict(phase="real", dtype=str(dtype), bucket=bi,
                              kind="dense" if isinstance(b, ht.DenseBucket) else "lr",
                              n_blocks=b.n_blocks, block_shape=b.block_shape,
                              rank=None if isinstance(b, ht.DenseBucket) else b.rank_padded,
                              k=k, bound_ms=bound, **r))
                    for name, v in r.items():
                        if name != "cut":
                            sums[(k, name)] = sums.get((k, name), 0.0) + v
                del b
            emit(dict(phase="real_sums", dtype=str(dtype),
                      sums={f"k{k}/{name}": v for (k, name), v in sorted(sums.items())}))

    # ---------------- one launch against two stages: the rule's measurements ----------------
    if "rule" in phases:
        from torch.profiler import ProfilerActivity, profile

        L = 50_000
        names = {"planned_one": "tiled_matvec_kernel", "planned_split": "stream_matvec_kernel",
                 "unplanned_one": "bucket_matvec_kernel", "unplanned_two": "bucket_stream_kernel"}
        shapes = ((64, 2), (64, 4), (64, 8), (128, 8), (128, 16), (224, 16), (416, 16), (416, 32),
                  (800, 32), (1568, 16), (128, 128), (416, 99))
        for dtype in (torch.float32, torch.complex64, torch.complex128):
            item = torch.empty((), dtype=dtype).element_size()
            for bm, r in shapes:
                per = 2 * bm * r * item
                seen = set()
                for total in (1 << 18, 1 << 20, 1 << 22, 1 << 24, 1 << 26):
                    nb = max(1, total // per)
                    if nb in seen:
                        continue
                    seen.add(nb)
                    b = rand_bucket("lr", nb, bm, bm, r, dtype, L)
                    # offsets on a grid of block rows, as a cluster's blocks
                    # lie in an H-matrix: consecutive blocks share their rows
                    ncol = L // bm - 1
                    i = torch.arange(nb, device=dev)
                    b = dataclasses.replace(b, t_off=bm * ((i // ncol) % ncol), s_off=bm * (i % ncol))
                    for trans in (False, True):
                        side = "s" if trans else "t"
                        p1 = build_tile_plan(b, side, L)
                        p2 = build_tile_plan_lr_split(b, side, L)
                        for k in (1, 8):
                            xp = randn(L, k, dtype=dtype)
                            y = torch.zeros((L, k), dtype=dtype, device=dev)
                            in_off, out_off = (b.t_off, b.s_off) if trans else (b.s_off, b.t_off)
                            calls = {
                                "planned_one": lambda: tiled_bucket_matvec(p1, xp, out=y),
                                "planned_split": lambda: tiled_bucket_matvec(p2, xp, out=y),
                                "unplanned_one": lambda: lr_bucket_matvec(
                                    b.U, b.V, in_off, out_off, xp, trans, L, out=y, split=False),
                                "unplanned_two": lambda: lr_bucket_matvec(
                                    b.U, b.V, in_off, out_off, xp, trans, L, out=y, split=True),
                            }
                            row = dict(phase="rule", dtype=str(dtype), nb=nb, bm=bm, r=r,
                                       block_bytes=per, bucket_bytes=nb * per, trans=trans, k=k,
                                       bound_us=1e6 * nb * per / 3.35e12)
                            for name, fn in calls.items():
                                row[name + "_us"] = 1e3 * sorted(
                                    event_ms(fn, reps=15) for _ in range(3))[1]
                            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                                for fn in calls.values():
                                    for _ in range(5):
                                        fn()
                                sync()
                            for name, kern in names.items():
                                row[name + "_dev_us"] = sum(
                                    e.device_time_total for e in prof.key_averages()
                                    if kern in e.key) / 5
                            emit(row)
                    del b

    # ---------------- wide low-rank buckets, unplanned ----------------
    WIDE = [(8, 3136, 3136, 512), (64, 800, 800, 256), (10, 6272, 6272, 8), (32, 1568, 1568, 99),
            (200, 416, 416, 32)]

    def time_wide(dtype, ks=(1, 8), bmm=True):
        L = 20_000
        for nb, bm, bn, r in WIDE:
            b = rand_bucket("lr", nb, bm, bn, r, dtype, L)
            for trans in (False, True):
                for k in ks:
                    xp = randn(L, k, dtype=dtype)
                    row = dict(phase="wide", dtype=str(dtype), nb=nb, bm=bm, bn=bn, r=r,
                               trans=trans, k=k, bound_ms=bucket_bytes(b) / 3.35e9,
                               one_launch=event_ms(lambda: unplanned(b, xp, trans, L, split=False)),
                               two_stage=event_ms(lambda: unplanned(b, xp, trans, L, split=True)))
                    if bmm:
                        in_off = b.t_off if trans else b.s_off
                        xg = xp[in_off[:, None] + torch.arange(bm if trans else bn, device=dev)]
                        ops = [b.V, b.U] if not trans else [b.U.transpose(1, 2), b.V.transpose(1, 2)]
                        row["bmm"] = event_ms(lambda: torch.bmm(ops[1], torch.bmm(ops[0], xg)))
                    y2 = unplanned(b, xp, trans, L, split=True)
                    row["rel_two_vs_one"] = rel(y2, unplanned(b, xp, trans, L, split=False))
                    emit(row)
            del b

    if "wide" in phases:
        time_wide(torch.complex64)
        time_wide(torch.float32, ks=(8,), bmm=False)
        time_wide(torch.complex128, ks=(8,), bmm=False)

    # ---------------- the unplanned symmetric product: host against device ----------------
    if "product" in phases:
        from htool_tpu_torch.hmatrix.linalg import matvec
        from htool_tpu_torch.ops import bucket_matvec as bucket_ops

        n = args.n
        pts = create_sphere(n, seed=0)
        pts_d = torch.as_tensor(pts.astype(np.float32), device=dev)
        gen = ht.KernelGenerator(laplace_kernel_symmetric, pts_d, pts_d)
        tree8 = ht.build_cluster_tree(pts, max_leaf_size=256, n_partitions=8)
        HS = ht.build_hmatrix(gen, tree8, epsilon=1e-3, eta=10.0, symmetry="S", UPLO="L")
        sync()
        saved = bucket_ops.lr_split_wanted
        for k in (1, 8):
            xr = randn(n, k, dtype=torch.float32)
            for name, rule in (("rule", saved), ("one_launch", lambda *a: False),
                               ("two_stage", lambda *a: True)):
                bucket_ops.lr_split_wanted = rule
                bucket_ops._lr_route.cache_clear()
                matvec(HS, xr)
                sync()
                t0 = time.perf_counter()
                for _ in range(20):
                    matvec(HS, xr)
                t_host = (time.perf_counter() - t0) / 20  # the host's enqueue time
                sync()
                t_all = (time.perf_counter() - t0) / 20
                emit(dict(phase="product", symmetry="S", k=k, lr_route=name,
                          host_enqueue_ms=1e3 * t_host, product_ms=1e3 * t_all))
        bucket_ops.lr_split_wanted = saved
        bucket_ops._lr_route.cache_clear()
        del HS

    # ---------------- device time of small terms ----------------
    # launches shorter than a wrapper call's host time (~30 us) cannot be timed
    # with events around a Python loop; a profiler trace gives the kernels'
    # own durations
    if "devtime" in phases:
        from torch.profiler import ProfilerActivity, profile

        L = 100_000
        for nb, bm, bn, r in ((2637, 224, 224, 16), (1385, 416, 416, 16), (661, 800, 800, 16),
                              (367, 1568, 1568, 16), (297, 3136, 3136, 16), (10, 6272, 6272, 8)):
            b = rand_bucket("lr", nb, bm, bn, r, torch.float32, L)
            for k in (1, 8):
                xp = randn(L, k, dtype=torch.float32)
                y = torch.zeros((L, k), dtype=torch.float32, device=dev)
                row = dict(phase="devtime", nb=nb, bm=bm, r=r, k=k,
                           bound_us=1e6 * bucket_bytes(b) / 3.35e12)
                for trans in (False, True):
                    in_off, out_off = (b.t_off, b.s_off) if trans else (b.s_off, b.t_off)
                    for split in (False, True):
                        call = lambda: lr_bucket_matvec(b.U, b.V, in_off, out_off, xp, trans, L,
                                                        out=y, split=split)
                        call()
                        sync()
                        with profile(activities=[ProfilerActivity.CUDA]) as prof:
                            for _ in range(10):
                                call()
                            sync()
                        us = sum(e.device_time_total for e in prof.key_averages()
                                 if "matvec_kernel" in e.key or "stream_kernel" in e.key) / 10
                        row[f"{'T' if trans else 'N'}/{'two_stage' if split else 'one_launch'}_us"] = us
                emit(row)
            del b

    # ---------------- the byte target of the cut rule ----------------
    if "target" in phases:
        saved = cut_mod._TARGET_BYTES
        for target in (32, 64, 128, 256, 512):
            cut_mod._TARGET_BYTES = target * 1024
            sums = {}
            for dtype in (torch.float32, torch.complex64):
                for b0 in buckets:
                    b = cast(b0, dtype)
                    for k in (1, 8):
                        xp = randn(m_pad, k, dtype=dtype)
                        if isinstance(b, ht.DenseBucket):
                            pl = build_tile_plan(b, "t", m_pad)
                            key = "dense"
                        else:
                            pl = build_tile_plan_lr_split(b, "t", m_pad)
                            key = "lr_split"
                        name = f"{str(dtype)[6:]}/k{k}/{key}"
                        sums[name] = sums.get(name, 0.0) + event_ms(
                            lambda: tiled_bucket_matvec(pl, xp))
                    del b
            L = 20_000
            for nb, bm, bn, r in WIDE[:3]:
                b = rand_bucket("lr", nb, bm, bn, r, torch.complex64, L)
                xp = randn(L, 8, dtype=torch.complex64)
                for trans in (False, True):
                    sums[f"wide/{bm}r{r}/trans{int(trans)}/k8"] = event_ms(
                        lambda: unplanned(b, xp, trans, L, split=True))
                del b
            emit(dict(phase="target", target_kib=target, ms=sums))
        cut_mod._TARGET_BYTES = saved

    # ---------------- the per-call floor ----------------
    if "floor" in phases:
        L = 64
        tiny_d = rand_bucket("dense", 1, 8, 8, 0, torch.float32, L)
        tiny_l = rand_bucket("lr", 1, 8, 8, 4, torch.float32, L)
        xp = randn(L, 1, dtype=torch.float32)
        y = torch.zeros((L, 1), dtype=torch.float32, device=dev)
        from htool_tpu_torch.ops.bucket_matvec import dense_bucket_matvec

        calls = {
            "tiled_dense": lambda pl=build_tile_plan(tiny_d, "t", L): tiled_bucket_matvec(
                pl, xp, out=y),
            "tiled_lr_one_launch": lambda pl=build_tile_plan(tiny_l, "t", L): tiled_bucket_matvec(
                pl, xp, out=y),
            "tiled_lr_split": lambda pl=build_tile_plan_lr_split(tiny_l, "t", L):
                tiled_bucket_matvec(pl, xp, out=y),
            "unplanned_dense": lambda: dense_bucket_matvec(
                tiny_d.data, tiny_d.s_off, tiny_d.t_off, xp, False, L, out=y),
            "unplanned_lr_one_launch": lambda: lr_bucket_matvec(
                tiny_l.U, tiny_l.V, tiny_l.s_off, tiny_l.t_off, xp, False, L, out=y, split=False),
            "unplanned_lr_two_stage": lambda: lr_bucket_matvec(
                tiny_l.U, tiny_l.V, tiny_l.s_off, tiny_l.t_off, xp, False, L, out=y, split=True),
            "torch_add_": lambda: y.add_(1.0),
        }
        res = {}
        for name, fn in calls.items():
            fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(1000):
                fn()
            host = (time.perf_counter() - t0) / 1000
            sync()
            res[name] = dict(host_us_per_call=1e6 * host,
                             device_us_per_call=1e3 * event_ms(fn, reps=1000))
        emit(dict(phase="floor", calls=1000, per_call=res))
    emit(dict(phase="done", ok=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
