"""Carry cluster trees, H-matrices, distributed H-matrices, GenEO coarse
spaces and (factorized or not) BLR and two-level BLR matrices across from
plain NumPy arrays.

Takes NumPy arrays only (no JAX): a caller that holds a JAX object turns
its fields into arrays with ``np.asarray`` and hands them over, so both
packages can work on the same tree, the same compressed operator or the same
coarse space.
"""

from __future__ import annotations

import numpy as np
import torch

from .clustering.cluster_tree import ClusterTree
from .hmatrix.blr import BLRMatrix
from .hmatrix.blr2 import TwoLevelBLR
from .hmatrix.hmatrix import DenseBucket, HMatrix, LowRankBucket
from .parallel.distributed import DistributedHMatrix, _layout_maps, default_mesh
from .solvers.geneo import GeneoCoarseSpace
from .utils.device import resolve_device

__all__ = ["tree_from_numpy", "hmatrix_from_numpy", "distributed_from_numpy",
           "geneo_from_numpy", "blr_from_numpy", "blr2_from_numpy"]


def tree_from_numpy(fields: dict) -> ClusterTree:
    """Build a :class:`ClusterTree` from its fields (``points``,
    ``permutation``, per-node arrays, ``partition_roots``, and the scalars
    ``is_permutation_local``/``max_leaf_size``)."""
    scalars = {"is_permutation_local": bool, "max_leaf_size": int}
    return ClusterTree(**{
        name: scalars[name](value) if name in scalars else np.array(value, copy=True)
        for name, value in fields.items()
    })


def hmatrix_from_numpy(d: dict, device=None) -> HMatrix:
    """Build an :class:`HMatrix` on ``device`` (default: the GPU, see
    :mod:`.utils.device`) from a dict with
    ``shape``, ``symmetry``, ``UPLO``, ``t_root_off``, ``perm_t``,
    ``perm_s`` and the bucket lists ``dense_buckets`` (dicts with ``data``,
    ``t_off``, ``s_off``, ``t_sizes``, ``s_sizes``, ``mirror``) and
    ``lr_buckets`` (dicts with ``U``, ``V``, ``t_off``, ``s_off``,
    ``t_sizes``, ``s_sizes``, ``ranks``, ``mirror``)."""
    device = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a, copy=True), dtype=dtype, device=device)

    def common(b):
        return dict(
            t_off=t(b["t_off"], torch.int64),
            s_off=t(b["s_off"], torch.int64),
            t_sizes=np.asarray(b["t_sizes"], np.int64),
            s_sizes=np.asarray(b["s_sizes"], np.int64),
            mirror=bool(b["mirror"]),
        )

    dense = [DenseBucket(data=t(b["data"]), **common(b)) for b in d["dense_buckets"]]
    lr = [
        LowRankBucket(U=t(b["U"]), V=t(b["V"]), ranks=np.asarray(b["ranks"], np.int64),
                      **common(b))
        for b in d["lr_buckets"]
    ]
    return HMatrix(
        shape=tuple(int(s) for s in d["shape"]),
        dense_buckets=dense,
        lr_buckets=lr,
        perm_t=t(d["perm_t"], torch.int64),
        perm_s=t(d["perm_s"], torch.int64),
        symmetry=str(d["symmetry"]),
        UPLO=str(d["UPLO"]),
        t_root_off=int(d["t_root_off"]),
    )


def distributed_from_numpy(d: dict, mesh=None, device=None) -> DistributedHMatrix:
    """Build a :class:`DistributedHMatrix` on ``mesh`` (default: a mesh of
    ``n_partitions`` partitions on ``device``, the GPU by default) from a
    dict with ``shape``, ``n_partitions``, ``perm_t``, ``perm_s``,
    ``part_offsets``, ``part_sizes``, ``m_loc_max``, ``symmetry``, ``UPLO``
    and the bucket lists ``dense_buckets`` / ``lr_buckets`` (dicts as for
    :func:`hmatrix_from_numpy`, every array with a leading partition axis
    ``[P, nb, ...]``).  With a process group, the mesh's process keeps its
    own partitions.  Padded blocks (true sizes 0) are pointed at their
    partition's first row on both sides, as the port's builder pads them:
    a mirrored term reads or writes the 's' side in the block row's local
    rows, where offset 0 of another partition would fall outside."""
    Pn = int(d["n_partitions"])
    if mesh is None:
        mesh = default_mesh(Pn, device=device)
    if mesh.n_partitions != Pn:
        raise ValueError(f"operator has {Pn} partitions but mesh has {mesh.n_partitions}")
    dev, lo, hi = mesh.device, mesh.lo, mesh.hi
    part_offsets = np.asarray(d["part_offsets"], np.int64)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(np.asarray(a)[lo:hi], copy=True), dtype=dtype,
                               device=dev)

    def common(b):
        t_sz = np.asarray(b["t_sizes"], np.int64)[lo:hi]
        pad = t_sz == 0
        offs = []
        for name in ("t_off", "s_off"):
            o = np.array(np.asarray(b[name])[lo:hi], np.int64)
            o[pad] = np.broadcast_to(part_offsets[lo:hi, None], o.shape)[pad]
            offs.append(torch.as_tensor(o, device=dev))
        return dict(t_off=offs[0], s_off=offs[1], t_sizes=t_sz,
                    s_sizes=np.asarray(b["s_sizes"], np.int64)[lo:hi], mirror=bool(b["mirror"]))

    part_sizes = np.asarray(d["part_sizes"], np.int64)
    return DistributedHMatrix(
        shape=tuple(int(s) for s in d["shape"]),
        n_partitions=Pn,
        dense_buckets=[DenseBucket(data=t(b["data"]), **common(b)) for b in d["dense_buckets"]],
        lr_buckets=[LowRankBucket(U=t(b["U"]), V=t(b["V"]),
                                  ranks=np.asarray(b["ranks"], np.int64)[lo:hi], **common(b))
                    for b in d["lr_buckets"]],
        perm_t=torch.as_tensor(np.asarray(d["perm_t"], np.int64), device=dev),
        perm_s=torch.as_tensor(np.asarray(d["perm_s"], np.int64), device=dev),
        part_offsets=part_offsets,
        part_sizes=part_sizes,
        m_loc_max=int(d["m_loc_max"]),
        mesh=mesh,
        symmetry=str(d["symmetry"]),
        UPLO=str(d["UPLO"]),
        **_layout_maps(part_offsets, part_sizes, int(d["shape"][0]), int(d["m_loc_max"]), dev),
    )


def geneo_from_numpy(d: dict, device=None) -> GeneoCoarseSpace:
    """Build a :class:`GeneoCoarseSpace` on ``device`` (default: the GPU, see
    :mod:`.utils.device`) from a dict with the coarse operator ``E``,
    ``nu_per_subdomain``, ``eigenvalues`` and either the replicated basis
    ``Z`` [N, nc] or the local store ``Z_loc`` [P, sz_max, nu_max],
    ``row_off``, ``row_size`` and ``nu_max``.  E is LU-factorized here."""
    device = resolve_device(device)
    E = torch.as_tensor(np.array(d["E"], copy=True), device=device)
    E_lu, E_piv = torch.linalg.lu_factor(E)
    nus = np.asarray(d["nu_per_subdomain"], np.int64)
    common = dict(E_lu=E_lu, E_piv=E_piv, size=int(nus.sum()), nu_per_subdomain=nus,
                  eigenvalues=[np.asarray(e) for e in d["eigenvalues"]])
    if d.get("Z") is not None:
        return GeneoCoarseSpace(Z=torch.as_tensor(np.array(d["Z"], copy=True), device=device),
                                **common)
    return GeneoCoarseSpace(
        Z=None, Z_loc=torch.as_tensor(np.array(d["Z_loc"], copy=True), device=device),
        row_off=np.asarray(d["row_off"], np.int64), row_size=np.asarray(d["row_size"], np.int64),
        nu_max=int(d["nu_max"]), **common)


def blr_from_numpy(d: dict, device=None) -> BLRMatrix:
    """Build a :class:`BLRMatrix` on ``device`` (default: the GPU, see
    :mod:`.utils.device`) from a dict of its fields: the host tables
    ``cell_off``, ``cell_size``, ``cls``, ``dense_slot``, ``lr_slot`` and
    ``permutation``, the cell arrays ``D``, ``U``, ``V``, ``ranks``, the
    scalars ``n``, ``b``, ``R_half``, ``epsilon``, ``factorized``, ``kind``,
    and ``piv``: the diagonal LU's row swaps, 0-based as the JAX package
    keeps them (``jax.scipy.linalg.lu_factor``), or None.  They are stored
    1-based, as ``torch.linalg.lu_factor`` gives them."""
    device = resolve_device(device)

    def t(name, dtype=None):
        return torch.as_tensor(np.array(d[name], copy=True), dtype=dtype, device=device)

    piv = d.get("piv")
    return BLRMatrix(
        n=int(d["n"]), b=int(d["b"]),
        cell_off=np.asarray(d["cell_off"], np.int64), cell_size=np.asarray(d["cell_size"], np.int64),
        cls=np.array(d["cls"], np.int8), dense_slot=np.array(d["dense_slot"], np.int32),
        lr_slot=np.array(d["lr_slot"], np.int32),
        D=t("D"), U=t("U"), V=t("V"), ranks=t("ranks", torch.int32),
        piv=None if piv is None else torch.as_tensor(np.asarray(piv, np.int64) + 1,
                                                     dtype=torch.int32, device=device),
        R_half=int(d["R_half"]), epsilon=float(d["epsilon"]),
        factorized=bool(d.get("factorized", False)), kind=str(d.get("kind", "lu")),
        permutation=None if d.get("permutation") is None else np.asarray(d["permutation"]),
        info=dict(d.get("info", {})),
    )


def blr2_from_numpy(d: dict, device=None) -> TwoLevelBLR:
    """Build a :class:`TwoLevelBLR` on ``device`` (default: the GPU) from a
    dict of its fields: ``n``, ``panel_off``, ``panel_size``, ``P``,
    ``diag_mode``, ``pU``, ``pV``, ``pRank``, ``R``, ``epsilon``,
    ``factorized``, ``kind``, ``permutation``, and the diagonal: ``Dd``
    [nC, P, P] with the row permutations ``perms`` of a factorized dense
    diagonal (A_K[perm] = L_K U_K, the convention of both packages), or
    ``diag``, a list of dicts, each one for :func:`blr_from_numpy` or, when
    it holds ``pU``, for this function (a nested panel)."""
    device = resolve_device(device)

    def t(name, dtype=None):
        return None if d.get(name) is None else torch.as_tensor(
            np.array(d[name], copy=True), dtype=dtype, device=device)

    diag = d.get("diag")
    if diag is not None:
        diag = [blr2_from_numpy(p, device) if "pU" in p else blr_from_numpy(p, device)
                for p in diag]
    return TwoLevelBLR(
        n=int(d["n"]), panel_off=np.asarray(d["panel_off"], np.int64),
        panel_size=np.asarray(d["panel_size"], np.int64), P=int(d["P"]),
        diag_mode=str(d["diag_mode"]), pU=t("pU"), pV=t("pV"), pRank=t("pRank", torch.int32),
        Dd=t("Dd"), diag=diag, perms=t("perms", torch.int64), R=int(d["R"]),
        epsilon=float(d["epsilon"]), factorized=bool(d.get("factorized", False)),
        kind=str(d.get("kind", "lu")),
        permutation=None if d.get("permutation") is None else np.asarray(d["permutation"]),
        info=dict(d.get("info", {})),
    )
