"""Distributed H-matrix information — min/mean/max reductions over
partitions plus the global compression ratio.

Port of ``htool_tpu/parallel/info.py`` (``get_distributed_hmatrix_information``
/ ``print_distributed_hmatrix_information``,
``hmatrix/hmatrix_distributed_output.hpp:31-225``).  The counts come from
the host size arrays; with a process group, each rank's per-partition
counts are gathered first (``all_gather_object``), so every rank reports
the same global figures."""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from .distributed import DistributedHMatrix

__all__ = ["distributed_hmatrix_info", "print_distributed_hmatrix_information"]


def _local_counts(d: DistributedHMatrix) -> list:
    """Per local partition: dense entries, low-rank entries, dense and
    low-rank block counts and the nonzero ranks."""
    per_part = [dict(dense=0.0, lr=0.0, nblocks_d=0, nblocks_l=0, ranks=[])
                for _ in range(d.mesh.n_local)]
    for b in d.dense_buckets:
        t = np.asarray(b.t_sizes, np.float64)
        s = np.asarray(b.s_sizes, np.float64)
        for i, q in enumerate(per_part):
            q["dense"] += float(np.sum(t[i] * s[i]))
            q["nblocks_d"] += int(np.sum(t[i] > 0))
    for b in d.lr_buckets:
        t = np.asarray(b.t_sizes, np.float64)
        s = np.asarray(b.s_sizes, np.float64)
        r = np.asarray(b.ranks, np.float64)
        for i, q in enumerate(per_part):
            q["lr"] += float(np.sum(r[i] * (t[i] + s[i])))
            q["nblocks_l"] += int(np.sum(r[i] > 0))
            q["ranks"].extend(r[i][r[i] > 0].tolist())
    return per_part


def distributed_hmatrix_info(d: DistributedHMatrix) -> dict:
    M, N = d.shape
    Pn = d.n_partitions
    per_part = _local_counts(d)
    if d.mesh.group is not None:
        gathered = [None] * d.mesh.world_size
        dist.all_gather_object(gathered, per_part, group=d.mesh.group)
        per_part = [q for part in gathered for q in part]

    local_generated = np.array([q["dense"] + q["lr"] for q in per_part])
    local_sizes = np.asarray(d.part_sizes, np.float64)
    local_totals = local_sizes * N
    local_ratio = np.where(local_generated > 0,
                           local_totals / np.maximum(local_generated, 1), np.inf)
    all_ranks = [x for q in per_part for x in q["ranks"]]

    def mmm(v):
        v = np.asarray(v, np.float64)
        return dict(min=float(v.min()), mean=float(v.mean()), max=float(v.max()))

    info = dict(
        target_size=M,
        source_size=N,
        n_partitions=Pn,
        # global reductions (the MPI_Reduce of the reference)
        compression_ratio=float(M) * N / float(local_generated.sum()),
        space_saving=1.0 - float(local_generated.sum()) / (float(M) * N),
        local_compression_ratio=mmm(local_ratio),
        local_n_dense_blocks=mmm([q["nblocks_d"] for q in per_part]),
        local_n_low_rank_blocks=mmm([q["nblocks_l"] for q in per_part]),
        rank=mmm(all_ranks) if all_ranks else dict(min=0, mean=0.0, max=0),
    )
    # timing reductions from the per-partition build infos, when present
    local_infos = d.info.get("local_infos")
    if local_infos:
        for key in ("assembly_walltime", "block_tree_walltime"):
            vals = [li[key] for li in local_infos if key in li]
            if vals:
                info[key] = mmm(vals)
    return info


def print_distributed_hmatrix_information(d: DistributedHMatrix) -> str:
    info = distributed_hmatrix_info(d)
    lines = ["Distributed HMatrix information:"]
    for k in sorted(info):
        v = info[k]
        if isinstance(v, dict):
            lines.append(
                f"  {k:<28} min {v['min']:.6g} | mean {v['mean']:.6g} | max {v['max']:.6g}"
            )
        else:
            lines.append(f"  {k:<28} {v}")
    s = "\n".join(lines)
    print(s)
    return s
