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
package's loader reads too, without plans.
"""

from __future__ import annotations

import csv

import numpy as np
import torch

from ..ops.tiled_matvec import SplitPlan, TilePlan
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


def _pack_plans(payload: dict, prefix: str, bucket) -> None:
    """One-launch plans under ``*_tplan_<side>``; the two stages of a split
    plan under ``*_tplan_<side>_a`` / ``_b`` with its ``r_pad``."""
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
    return TilePlan(**blocks, **aux, **ints)


def _unpack_plans(z, prefix: str, bucket, device) -> None:
    for side in ("t", "s"):
        key = f"{prefix}_tplan_{side}"
        if f"{key}_split" in z:
            # stage A streams V then stage B U; transposed (side "s"): U then V
            first, second = (bucket.V, bucket.U) if side == "t" else (bucket.U, bucket.V)
            plan = SplitPlan(
                _unpack_plan(z, f"{key}_a", dict(kind="dense", data=first), device),
                _unpack_plan(z, f"{key}_b", dict(kind="dense", data=second), device),
                int(z[f"{key}_split"][0]))
        elif f"{key}_aux" in z:
            blocks = (dict(kind="dense", data=bucket.data) if isinstance(bucket, DenseBucket)
                      else dict(kind="lr", U=bucket.U, V=bucket.V))
            plan = _unpack_plan(z, key, blocks, device)
        else:
            continue
        setattr(bucket, f"plan_{side}", plan)


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
            _unpack_plans(z, f"d{k}", b, device)
            dense.append(b)
        for k in range(int(z["n_lr"][0])):
            b = LowRankBucket(U=dev(z[f"l{k}_U"]), V=dev(z[f"l{k}_V"]),
                              ranks=np.asarray(z[f"l{k}_ranks"], np.int64),
                              **common(f"l{k}"))
            _unpack_plans(z, f"l{k}", b, device)
            lr.append(b)
        return HMatrix(
            shape=tuple(int(x) for x in z["shape"]),
            dense_buckets=dense,
            lr_buckets=lr,
            perm_t=dev(z["perm_t"], torch.int64),
            perm_s=dev(z["perm_s"], torch.int64),
            symmetry=str(z["symmetry"][0]),
            UPLO=str(z["UPLO"][0]),
            t_root_off=int(z["t_root_off"][0]),
        )
