"""H-matrix structure outputs and persistence.

Port of ``htool_tpu/hmatrix/output.py``: per-leaf CSV with ranks and
per-extent aggregates for the plotting tools
(``hmatrix/hmatrix_output.hpp``: ``save_leaves_with_rank:39``,
``save_levels:58``), a Graphviz view of the leaves, and an npz file of the
whole compressed operator.

The npz layout of the buckets is the JAX package's, so :func:`load_hmatrix`
reads a file that ``htool_tpu.hmatrix.output.save_hmatrix`` wrote (its tiled
plans are TPU layouts and are not read: :func:`..linalg.prepare_tiled_matvec`
makes the port's own).  The port stores its own :class:`TilePlan` fields
under keys of their own (``*_tplan_*``), so a file it wrote is one the JAX
package's loader reads too, without plans.  A file from before every
low-rank plan was split can hold a one-launch plan of a low-rank bucket
(``*_tplan_<side>_aux`` on an ``l`` bucket): the loader builds that
bucket's split plan from the bucket itself.  A mirror bucket's pair plan
(``bucket.pair``, :class:`..ops.pair_matvec.PairPlan`) is stored under
``*_tplan_pair_*``; a file from before the pair pass holds per-term
plans for such a bucket, and the loader builds its pair plan instead, where
the pass takes the bucket.
"""

from __future__ import annotations

import csv

import numpy as np
import torch

from ..ops.pair_matvec import PairPlan, build_pair_plan
from ..ops.tiled_matvec import SplitPlan, TilePlan, build_tile_plan_lr_split
from ..utils.device import resolve_device
from .hmatrix import DenseBucket, HMatrix, LowRankBucket

__all__ = [
    "save_leaves_with_rank",
    "save_levels",
    "view_block_tree",
    "load_hmatrix",
    "save_hmatrix",
]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _iter_leaves(h: HMatrix):
    """Yield (t_off, t_size, s_off, s_size, kind, rank, mirror) per leaf."""
    for b in h.dense_buckets:
        t_off, s_off = _host(b.t_off), _host(b.s_off)
        t_sz, s_sz = np.asarray(b.t_sizes), np.asarray(b.s_sizes)
        for i in range(t_off.shape[0]):
            yield t_off[i], t_sz[i], s_off[i], s_sz[i], "dense", -1, b.mirror
    for b in h.lr_buckets:
        t_off, s_off = _host(b.t_off), _host(b.s_off)
        t_sz, s_sz = np.asarray(b.t_sizes), np.asarray(b.s_sizes)
        rk = np.asarray(b.ranks)
        for i in range(t_off.shape[0]):
            yield t_off[i], t_sz[i], s_off[i], s_sz[i], "lr", int(rk[i]), b.mirror


def save_leaves_with_rank(h: HMatrix, filename: str) -> None:
    """CSV rows: t_off, t_size, s_off, s_size, kind, rank, mirror —
    the block-picture input (tools/plot_hmatrix.py)."""
    with open(filename, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["t_off", "t_size", "s_off", "s_size", "kind", "rank", "mirror"])
        for t_off, t_sz, s_off, s_sz, kind, rank, mirror in _iter_leaves(h):
            w.writerow([t_off, t_sz, s_off, s_sz, kind, rank, int(mirror)])


def save_levels(h: HMatrix, filename: str) -> None:
    """Per-level aggregate CSV (``save_levels``, hmatrix_output.hpp:58): the
    flat layout has no stored tree depth, so the level is reconstructed
    from the block extent — rows: level proxy (max block extent), #dense,
    #lr, rank min/mean/max."""
    by_extent: dict[int, list] = {}
    for t_off, t_sz, s_off, s_sz, kind, rank, _ in _iter_leaves(h):
        by_extent.setdefault(int(max(t_sz, s_sz)), []).append((kind, rank))
    with open(filename, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["block_extent", "n_dense", "n_lr", "rank_min", "rank_mean", "rank_max"])
        for ext in sorted(by_extent, reverse=True):
            rows = by_extent[ext]
            ranks = [r for k, r in rows if k == "lr"]
            w.writerow([
                ext,
                sum(1 for k, _ in rows if k == "dense"),
                len(ranks),
                min(ranks) if ranks else 0,
                float(np.mean(ranks)) if ranks else 0.0,
                max(ranks) if ranks else 0,
            ])


def view_block_tree(h: HMatrix, filename: str | None = None) -> str:
    """Graphviz DOT of the block structure (``view_block_tree``,
    hmatrix_output_dot.hpp:51-210): one node per leaf labeled with its
    (rows × cols [rank]) footprint, colored green (low-rank) / red (dense)."""
    lines = [
        "digraph block_tree {",
        "  node [shape=box, style=filled];",
        f'  root [label="{h.shape[0]} x {h.shape[1]}", fillcolor=lightgray];',
    ]
    for i, (t_off, t_sz, s_off, s_sz, kind, rank, mirror) in enumerate(_iter_leaves(h)):
        label = f"[{t_off},{t_off + t_sz})x[{s_off},{s_off + s_sz})"
        if kind == "lr":
            label += f" r={rank}"
        color = "palegreen" if kind == "lr" else "lightcoral"
        if mirror:
            label += " +mirror"
        lines.append(f'  b{i} [label="{label}", fillcolor={color}];')
        lines.append(f"  root -> b{i};")
    lines.append("}")
    dot = "\n".join(lines)
    if filename:
        with open(filename, "w") as f:
            f.write(dot)
    return dot


_PLAN_INTS = ("blk", "in_off", "out_rel", "out_off", "tile_of", "first_of")
_PLAN_AUX = ("T", "E", "G", "n_steps", "n_tiles", "out_len", "in_w", "out_w", "trans",
             "in_end", "P")


def _pack_plan(payload: dict, key: str, plan: TilePlan) -> None:
    payload[f"{key}_aux"] = np.array([int(getattr(plan, a)) for a in _PLAN_AUX], np.int64)
    for name in _PLAN_INTS:
        payload[f"{key}_{name}"] = _host(getattr(plan, name))
    # the live extents (dense plans over buckets that know their sizes)
    if plan.ext is not None:
        payload[f"{key}_ext"] = _host(plan.ext)
        payload[f"{key}_ext_max"] = np.array(plan.ext_max, np.int64)
    payload[f"{key}_read_bytes"] = np.array(plan.read_bytes, np.int64)


_PAIR_AUX = ("n_items", "tile_rows", "rows", "cols", "rank", "live", "out_len")


def _pack_plans(payload: dict, prefix: str, bucket) -> None:
    """Dense plans under ``*_tplan_<side>``; the two stages of a split plan
    under ``*_tplan_<side>_a`` / ``_b`` with its ``r_pad``; a pair plan
    under ``*_tplan_pair``."""
    if bucket.pair is not None:
        plan = bucket.pair
        payload[f"{prefix}_tplan_pair_aux"] = np.array([getattr(plan, a) for a in _PAIR_AUX],
                                                       np.int64)
        payload[f"{prefix}_tplan_pair_items"] = _host(plan.items)
    for side in ("t", "s"):
        plan = getattr(bucket, f"plan_{side}")
        key = f"{prefix}_tplan_{side}"
        if isinstance(plan, SplitPlan):
            payload[f"{key}_split"] = np.array([plan.r_pad], np.int64)
            _pack_plan(payload, f"{key}_a", plan.stage_a)
            _pack_plan(payload, f"{key}_b", plan.stage_b)
        elif plan is not None:
            _pack_plan(payload, key, plan)


def _unpack_plan(z, key: str, blocks: dict, device) -> TilePlan:
    aux = dict(zip(_PLAN_AUX, (int(a) for a in z[f"{key}_aux"])))  # older files: no P
    aux["trans"] = bool(aux["trans"])
    ints = {name: torch.as_tensor(z[f"{key}_{name}"], device=device) for name in _PLAN_INTS}
    if f"{key}_ext" in z:  # older files: no extents, whole blocks
        ints["ext"] = torch.as_tensor(z[f"{key}_ext"], device=device)
        aux["ext_max"] = tuple(int(a) for a in z[f"{key}_ext_max"])
    if f"{key}_read_bytes" in z:
        aux["read_bytes"] = tuple(int(a) for a in z[f"{key}_read_bytes"])
    return TilePlan(**blocks, **aux, **ints)


def _unpack_plans(z, prefix: str, bucket, device, pairs: bool) -> None:
    """The bucket's plans from the file.  ``pairs``: the operator is square
    and symmetric or hermitian, so a mirror bucket takes a pair plan."""
    key = f"{prefix}_tplan_pair"
    if f"{key}_aux" in z:
        aux = dict(zip(_PAIR_AUX, (int(a) for a in z[f"{key}_aux"])))
        lr = isinstance(bucket, LowRankBucket)
        bucket.pair = PairPlan(
            kind="lr" if lr else "dense", data=bucket.U if lr else bucket.data,
            V=bucket.V if lr else None, items=torch.as_tensor(z[f"{key}_items"], device=device),
            **aux)
        return
    for side in ("t", "s"):
        key = f"{prefix}_tplan_{side}"
        if f"{key}_split" in z:
            # stage A streams V then stage B U; transposed (side "s"): U then V
            first, second = (bucket.V, bucket.U) if side == "t" else (bucket.U, bucket.V)
            plan = SplitPlan(_unpack_plan(z, f"{key}_a", dict(data=first), device),
                             _unpack_plan(z, f"{key}_b", dict(data=second), device),
                             int(z[f"{key}_split"][0]))
        elif f"{key}_aux" in z and isinstance(bucket, DenseBucket):
            plan = _unpack_plan(z, key, dict(data=bucket.data), device)
        elif f"{key}_aux" in z and bucket.rank_padded > 0:
            # a one-launch plan of a low-rank bucket: the split plan of the same tiles
            aux = dict(zip(_PLAN_AUX, (int(a) for a in z[f"{key}_aux"])))
            plan = build_tile_plan_lr_split(bucket, side, aux["out_len"], aux["T"])
        else:
            continue
        setattr(bucket, f"plan_{side}", plan)
    if pairs and bucket.mirror and bucket.plan_t is not None:
        # per-term plans of a file from before the pair pass: the pair plan
        # over the same padded vectors, where the pass takes the bucket
        bucket.pair = build_pair_plan(bucket, bucket.plan_t.out_len)
        if bucket.pair is not None:
            bucket.plan_t = bucket.plan_s = None


def save_hmatrix(h: HMatrix, filename: str, include_plans: bool = True) -> None:
    """Persist the full compressed H-matrix (npz), including any attached
    tiled-product plans.  The reference does not serialize H-matrices
    (SURVEY.md §5 checkpoint/resume)."""
    payload = dict(
        shape=np.array(h.shape),
        symmetry=np.array([h.symmetry]),
        UPLO=np.array([h.UPLO]),
        t_root_off=np.array([h.t_root_off]),
        perm_t=_host(h.perm_t),
        perm_s=_host(h.perm_s),
        n_dense=np.array([len(h.dense_buckets)]),
        n_lr=np.array([len(h.lr_buckets)]),
    )
    for k, b in enumerate(h.dense_buckets):
        payload[f"d{k}_data"] = _host(b.data)
    for k, b in enumerate(h.lr_buckets):
        payload[f"l{k}_U"] = _host(b.U)
        payload[f"l{k}_V"] = _host(b.V)
        payload[f"l{k}_ranks"] = np.asarray(b.ranks)
    for prefix, b in [(f"d{k}", b) for k, b in enumerate(h.dense_buckets)] + \
                     [(f"l{k}", b) for k, b in enumerate(h.lr_buckets)]:
        payload[f"{prefix}_t_off"] = _host(b.t_off)
        payload[f"{prefix}_s_off"] = _host(b.s_off)
        payload[f"{prefix}_t_sizes"] = np.asarray(b.t_sizes)
        payload[f"{prefix}_s_sizes"] = np.asarray(b.s_sizes)
        payload[f"{prefix}_mirror"] = np.array([int(b.mirror)])
        if include_plans:
            _pack_plans(payload, prefix, b)
    np.savez_compressed(filename, **payload)


def load_hmatrix(filename: str, device=None) -> HMatrix:
    """Load an H-matrix written by :func:`save_hmatrix` (or by the JAX
    package's ``save_hmatrix``) onto ``device`` (default: the GPU, see
    :mod:`..utils.device`)."""
    device = resolve_device(device)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    with np.load(filename, allow_pickle=False) as z:
        shape = tuple(int(x) for x in z["shape"])
        pairs = str(z["symmetry"][0]) in ("S", "H") and shape[0] == shape[1]

        def common(prefix):
            return dict(
                t_off=dev(z[f"{prefix}_t_off"], torch.int64),
                s_off=dev(z[f"{prefix}_s_off"], torch.int64),
                t_sizes=np.asarray(z[f"{prefix}_t_sizes"], np.int64),
                s_sizes=np.asarray(z[f"{prefix}_s_sizes"], np.int64),
                mirror=bool(z[f"{prefix}_mirror"][0]),
            )

        dense, lr = [], []
        for k in range(int(z["n_dense"][0])):
            b = DenseBucket(data=dev(z[f"d{k}_data"]), **common(f"d{k}"))
            _unpack_plans(z, f"d{k}", b, device, pairs)
            dense.append(b)
        for k in range(int(z["n_lr"][0])):
            b = LowRankBucket(U=dev(z[f"l{k}_U"]), V=dev(z[f"l{k}_V"]),
                              ranks=np.asarray(z[f"l{k}_ranks"], np.int64),
                              **common(f"l{k}"))
            _unpack_plans(z, f"l{k}", b, device, pairs)
            lr.append(b)
        return HMatrix(
            shape=shape,
            dense_buckets=dense,
            lr_buckets=lr,
            perm_t=dev(z["perm_t"], torch.int64),
            perm_s=dev(z["perm_s"], torch.int64),
            symmetry=str(z["symmetry"][0]),
            UPLO=str(z["UPLO"][0]),
            t_root_off=int(z["t_root_off"][0]),
        )
