#!/usr/bin/env python3
"""The distributed operator and the Schwarz + GMRES solve over several
processes, one rank a card: the PyTorch port's counterpart of
``__graft_entry__.py``'s ``dryrun_multichip`` and of the reference's
``mpiexec -np W``.

Two ways to start it:

    python3 torch_multichip.py --world 4            # starts 4 ranks itself
    torchrun --nproc-per-node=4 torch_multichip.py  # each process is one rank

With ``--world W`` this process starts W copies of itself, rank r with
``RANK=r``, ``WORLD_SIZE=W`` and ``LOCAL_RANK=r`` in its environment (as a
launcher sets them), wired through a file store in a temporary directory
(no network).  It kills every rank when one overruns ``--timeout`` seconds
or fails, prints one JSON line a rank and then a summary line, and exits
nonzero if any rank failed.  Under a launcher (``RANK`` and ``WORLD_SIZE``
set) the process is one rank and joins the group through ``env://``, or
through ``--init-method``.

Each rank, on its own card (``cuda:{LOCAL_RANK}``; ``--backend gloo``
lets ranks share one) or with ``--device cpu`` on the CPU:

1. builds the sphere of ``--n`` points (100,000) and the Laplace kernel in
   ``--dtype`` (float32);
2. builds the cluster tree, leaf 256, with ``--partitions`` P partitions
   (default W: one partition a rank), and the mesh over the group
   (``global_mesh``): rank r holds partitions [r·P/W, (r+1)·P/W);
3. builds its block rows of the distributed operator only
   (``build_distributed_hmatrix``, ε = 1e-3, η = 10);
4. applies the g2g product N and T at k = 8 and times them (CUDA events on
   the card, the host clock on the CPU);
5. runs ``DistributedDDMSolver(schwarz="ras", overlap_radius=0.02,
   local_solver="dense")`` with GMRES(60) to 1e-6 on a random right-hand
   side, cold and warm, and the true residual through the operator;
6. checks ``dryrun_multichip``'s assertions in the port's terms: the local
   LU factors are ``[P_local, n_ext_max, n_ext_max]`` on its own device and
   ``n_ext_max < n``, and every bucket tensor lies on that device;
7. writes its rows (its partitions' points) of y = A x, y = Aᵀ x and the
   solution, its iterations, times, card, peak memory, the launches of the
   two unplanned product kernels over its run and the calls of their plain
   versions, to ``--out`` (``rank{r}.json``, ``rank{r}.npz``).

The parent gathers the rows into ``gathered.npz`` (``y_N``, ``y_T``, ``x``
in user numbering, the tree's permutation and partition offsets) and the
summary into ``summary.json`` when ``--out`` names a directory.  x and the
right-hand side are made from ``--seed`` with NumPy: ``RandomState(seed)
.randn(n, 8)`` and ``RandomState(seed + 1).randn(n)``.
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

import numpy as np

LEAF, EPS, ETA, OVERLAP, TOL, RESTART, K = 256, 1e-3, 10.0, 0.02, 1e-6, 60, 8


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="start this many ranks (without it: one rank under a launcher)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--partitions", type=int, default=None, help="default: the world size")
    ap.add_argument("--n", type=int, default=100_000, help="number of points")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a rank may run before the parent kills every rank")
    ap.add_argument("--out", default=None, help="directory for the ranks' and the gathered "
                                                "results")
    ap.add_argument("--init-method", default=None,
                    help="torch.distributed init method of a rank (default: env://)")
    args = ap.parse_args(argv)
    if args.backend is None:
        args.backend = "gloo" if args.device == "cpu" else "nccl"
    if args.backend == "nccl" and args.device == "cpu":
        ap.error("NCCL moves CUDA tensors: use --backend gloo with --device cpu")
    return args


# ----------------------------------------------------------------------
# one rank
# ----------------------------------------------------------------------


def run_rank(args) -> dict:
    import torch

    import htool_tpu_torch as ht
    from htool_tpu_torch.parallel import initialize_multihost, shutdown_multihost

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the ranks on the CPU")
    if not on_card:
        ht.set_default_device("cpu")
    initialize_multihost(args.init_method, world, rank, backend=args.backend,
                         device=args.device)
    try:
        return _rank_work(args, rank, world)
    finally:
        shutdown_multihost()


def _rank_work(args, rank: int, world: int) -> dict:
    import torch

    import htool_tpu_torch as ht
    import htool_tpu_torch.ops.bucket_matvec as bucket_ops
    from htool_tpu_torch.ops.bucket_matvec import dense_bucket_matvec, lr_bucket_matvec
    from htool_tpu_torch.parallel import build_distributed_hmatrix, global_mesh
    from htool_tpu_torch.solvers import DistributedDDMSolver
    from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

    on_card = args.device == "cuda"
    # the rank's device: its card, which initialize_multihost made current
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    n, P = args.n, args.partitions or world
    real = np.float32 if args.dtype == "float32" else np.float64

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def product_ms(fn, reps=3):
        fn()
        if not on_card:
            return 1e3 * timed(lambda: [fn() for _ in range(reps)])[1] / reps
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        sync()
        return e0.elapsed_time(e1) / reps

    # the launches of the two unplanned kernels over this rank's run, and the
    # calls of their plain versions (none on a CUDA tensor)
    wrappers = (dense_bucket_matvec, lr_bucket_matvec)
    for w in wrappers:
        w.launches = w.cuda_launches = 0
        w.launches_by_dtype.clear()
        w.launches_by_k.clear()
    plain_calls = {}
    for name in ("dense_bucket_matvec_reference", "lr_bucket_matvec_reference"):
        fn = getattr(bucket_ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            plain_calls[_name] = plain_calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        setattr(bucket_ops, name, counted)

    t_start = time.perf_counter()
    pts = create_sphere(n, seed=args.seed)
    pts_d = torch.as_tensor(pts.astype(real), device=dev)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts_d, pts_d)
    tree, tree_s = timed(lambda: ht.build_cluster_tree(pts, max_leaf_size=LEAF, n_partitions=P))
    mesh = global_mesh(P, device=dev)
    D, build_s = timed(lambda: build_distributed_hmatrix(gen, tree, mesh, epsilon=EPS, eta=ETA))

    x = torch.as_tensor(np.random.RandomState(args.seed).randn(n, K).astype(real), device=dev)
    b = torch.as_tensor(np.random.RandomState(args.seed + 1).randn(n).astype(real), device=dev)
    y = {op: D.matvec(x, op=op) for op in ("N", "T")}
    ms = {op: product_ms(lambda op=op: D.matvec(x, op=op)) for op in ("N", "T")}

    s, setup_s = timed(lambda: DistributedDDMSolver(D, gen, tree, schwarz="ras",
                                                    overlap_radius=OVERLAP,
                                                    local_solver="dense"))
    solves = []
    for _ in range(2):  # cold, warm
        (xs, infos), t = timed(lambda: s.solve(b, tol=TOL, krylov="gmres", restart=RESTART,
                                               maxiter=200))
        solves.append(t)
    residual = float(torch.linalg.norm(D @ xs - b) / torch.linalg.norm(b))
    sync()
    launches = {w.__name__: w.launches for w in wrappers}

    # dryrun_multichip's assertions: the local factors are this rank's
    # partitions only, extended-subdomain sized, on this rank's device
    lu = next(iter(s._lu.values()))
    n_ext = s.halo.n_ext_max
    if tuple(lu.shape) != (mesh.n_local, n_ext, n_ext) or not n_ext < n:
        raise AssertionError(f"local LU {tuple(lu.shape)}: not [{mesh.n_local}, {n_ext}, "
                             f"{n_ext}] with n_ext_max < {n}")
    held = [lu, xs, y["N"], y["T"]] + [t for bk in D.dense_buckets + D.lr_buckets
                                       for t in ((bk.data,) if isinstance(bk, ht.DenseBucket)
                                                 else (bk.U, bk.V)) + (bk.t_off, bk.s_off)]
    off_device = sum(t.device != dev for t in held)
    if off_device:
        raise AssertionError(f"{off_device} of {len(held)} tensors are not on {dev}")

    # this rank's rows: the points of its partitions, in user numbering
    offs, sizes = tree.partition_offsets_sizes()
    rows = np.concatenate([tree.permutation[int(offs[p]) : int(offs[p]) + int(sizes[p])]
                           for p in range(mesh.lo, mesh.hi)])
    rows_t = torch.as_tensor(rows, device=dev)
    arrays = dict(rows=rows, y_N=y["N"][rows_t].cpu().numpy(), y_T=y["T"][rows_t].cpu().numpy(),
                  x=xs[rows_t].cpu().numpy(), permutation=np.asarray(tree.permutation),
                  part_offsets=np.asarray(offs), part_sizes=np.asarray(sizes))
    card = dict(device=str(dev))
    if on_card:
        props = torch.cuda.get_device_properties(dev)
        card.update(name=props.name, uuid=str(getattr(props, "uuid", "")))
    info = dict(
        rank=rank, world=world, backend=mesh.backend, partitions=P,
        local_partitions=[mesh.lo, mesh.hi], n=n, dtype=args.dtype, card=card, tree_s=tree_s, build_s=build_s,
        product_ms_k8=ms, setup_s=setup_s, solve_cold_s=solves[0], solve_warm_s=solves[1],
        iterations=infos["Nb_it"], residual=residual, lu_shape=list(lu.shape), n_ext_max=n_ext,
        tensors_on_card=off_device == 0, launches=launches, plain_version_calls=plain_calls,
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev) if on_card else None,
        rank_s=time.perf_counter() - t_start)
    return dict(info=info, arrays=arrays)


def rank_main(args) -> int:
    result = run_rank(args)
    info = result["info"]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        r = info["rank"]
        np.savez(os.path.join(args.out, f"rank{r}.npz"), **result["arrays"])
        with open(os.path.join(args.out, f"rank{r}.json"), "w") as f:
            json.dump(info, f)
    print(json.dumps(info), flush=True)
    return 0


# ----------------------------------------------------------------------
# the parent: W ranks, a file store, a time limit
# ----------------------------------------------------------------------


def _prebuild(device: str) -> None:
    """Build what every rank loads (the CUDA kernels, the native planner)
    once, before the ranks start: W ranks would otherwise each compile."""
    from htool_tpu_torch import native

    native.native_available()
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch_multichip: no CUDA device (pass --device cpu for the CPU)")
        from htool_tpu_torch.kernels import load_library

        load_library()


def _launch(args, out: str, store: str) -> tuple:
    """Start the W ranks; returns (their processes, their log paths)."""
    argv = [sys.executable, os.path.abspath(__file__), "--backend", args.backend,
            "--partitions", str(args.partitions or args.world), "--n", str(args.n),
            "--device", args.device, "--dtype", args.dtype, "--seed", str(args.seed),
            "--init-method", f"file://{store}", "--out", out]
    procs, logs = [], []
    for r in range(args.world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(args.world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(args.world))
        # the ranks share this host: their transports connect over loopback
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        logs.append(os.path.join(out, f"rank{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(argv, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs, logs


def _wait(procs, timeout: float) -> dict:
    """Wait for every rank; the first that fails, or the time limit, ends
    them all (a rank whose peer is gone waits in a collective for ever).
    Returns {rank: reason} of the ranks that did not succeed."""
    deadline = time.monotonic() + timeout
    failed = {}
    try:
        while any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                if p.poll() not in (None, 0) and r not in failed:
                    failed[r] = f"exit code {p.returncode}"
            overran = time.monotonic() > deadline
            if failed or overran:
                for r, p in enumerate(procs):
                    if p.poll() is None:
                        failed[r] = (f"overran its time limit of {timeout:g} s" if overran
                                     else "killed: another rank failed")
                        p.kill()
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0 and r not in failed:
            failed[r] = f"exit code {p.returncode}"
    return failed


def _gather(infos, arrays, n: int) -> dict:
    """The ranks' rows put together, in user numbering."""
    rows = np.concatenate([a["rows"] for a in arrays])
    if rows.size != n or np.unique(rows).size != n:
        raise AssertionError(f"the ranks' rows do not cover the {n} points once")
    out = {}
    for key in ("y_N", "y_T", "x"):
        v = np.concatenate([a[key] for a in arrays])
        full = np.zeros((n, *v.shape[1:]), v.dtype)
        full[rows] = v
        out[key] = full
    for key in ("permutation", "part_offsets", "part_sizes"):
        if any(not np.array_equal(a[key], arrays[0][key]) for a in arrays):
            raise AssertionError(f"the ranks built different trees ({key})")
        out[key] = arrays[0][key]
    return out


def parent_main(args) -> int:
    t0 = time.perf_counter()
    if args.world < 1:
        raise SystemExit("--world must be at least 1")
    _prebuild(args.device)
    keep = args.out is not None
    out = os.path.abspath(args.out) if keep else tempfile.mkdtemp(prefix="torch_multichip_")
    os.makedirs(out, exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="torch_multichip_store_")
    try:
        procs, logs = _launch(args, out, os.path.join(store_dir, "store"))
        failed = _wait(procs, args.timeout)
        if failed:
            for r in sorted(failed):
                with open(logs[r], errors="replace") as f:
                    tail = f.read()[-3000:]
                print(f"rank {r}: {failed[r]}\n{tail}", file=sys.stderr)
            print(json.dumps(dict(ok=False, world=args.world, failed=failed,
                                  wall_s=time.perf_counter() - t0)), flush=True)
            return 1
        infos, arrays = [], []
        for r in range(args.world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                infos.append(json.load(f))
            arrays.append(dict(np.load(os.path.join(out, f"rank{r}.npz"))))
        gathered = _gather(infos, arrays, args.n)
        for info in infos:
            print(json.dumps(info), flush=True)
        cards = [i["card"] for i in infos]
        summary = dict(
            ok=True, world=args.world, backend=infos[0]["backend"],
            partitions=infos[0]["partitions"], n=args.n, dtype=args.dtype,
            cards=[c["device"] for c in cards],
            distinct_cards=len({c.get("uuid") or c["device"] for c in cards}) == len(cards),
            iterations=[i["iterations"] for i in infos],
            residual_max=max(i["residual"] for i in infos),
            product_ms_k8_max={op: max(i["product_ms_k8"][op] for i in infos)
                               for op in ("N", "T")},
            build_s_max=max(i["build_s"] for i in infos),
            setup_s_max=max(i["setup_s"] for i in infos),
            solve_cold_s_max=max(i["solve_cold_s"] for i in infos),
            solve_warm_s_max=max(i["solve_warm_s"] for i in infos),
            peak_memory_bytes=[i["peak_memory_bytes"] for i in infos],
            launches=[i["launches"] for i in infos],
            plain_version_calls=[i["plain_version_calls"] for i in infos],
            wall_s=time.perf_counter() - t0)
        if keep:
            np.savez(os.path.join(out, "gathered.npz"), **gathered)
            with open(os.path.join(out, "summary.json"), "w") as f:
                json.dump(dict(summary, ranks=infos), f)
        print(json.dumps(summary), flush=True)
        if len(set(summary["iterations"])) != 1:
            print(f"the ranks disagree on the iteration count: {summary['iterations']}",
                  file=sys.stderr)
            return 1
        return 0
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
        if not keep:
            shutil.rmtree(out, ignore_errors=True)


def main(argv=None) -> int:
    args = _args(argv)
    if args.world is None:
        if not (os.environ.get("RANK") and os.environ.get("WORLD_SIZE")):
            raise SystemExit("torch_multichip: pass --world W, or start it under a launcher "
                             "that sets RANK and WORLD_SIZE (torchrun)")
        return rank_main(args)
    return parent_main(args)


if __name__ == "__main__":
    sys.exit(main())
