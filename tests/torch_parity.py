"""Helpers for the parity tests of the PyTorch port: turn JAX-package objects
into the plain NumPy dicts that ``htool_tpu_torch.convert`` takes.

Importing this module also asks the port for the CPU: its entry points put
NumPy input on the GPU unless told otherwise, and these tests run without
one.  Every ``tests/test_torch_*.py`` imports it.  It also keeps torch's and
NumPy's BLAS work on one thread each: the suite runs in several worker
processes, each with JAX's own thread pool, and more threads on top of
those only contend for the same cores."""

import dataclasses

import numpy as np
import torch
from threadpoolctl import threadpool_limits

import htool_tpu_torch

htool_tpu_torch.set_default_device("cpu")
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")


def tree_fields(tree) -> dict:
    """All fields of a JAX-package ClusterTree as NumPy arrays / scalars."""
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}


def hmatrix_to_numpy(H) -> dict:
    """The JAX HMatrix's structure and buckets as NumPy arrays (a
    DistributedHMatrix's too, which has no ``t_root_off``)."""

    def common(b):
        return dict(
            t_off=np.asarray(b.t_off), s_off=np.asarray(b.s_off),
            t_sizes=np.asarray(b.t_sizes), s_sizes=np.asarray(b.s_sizes),
            mirror=bool(b.mirror),
        )

    return dict(
        shape=tuple(H.shape), symmetry=H.symmetry, UPLO=H.UPLO,
        t_root_off=int(getattr(H, "t_root_off", 0)),
        perm_t=np.asarray(H.perm_t), perm_s=np.asarray(H.perm_s),
        dense_buckets=[dict(data=np.asarray(b.data), **common(b)) for b in H.dense_buckets],
        lr_buckets=[
            dict(U=np.asarray(b.U), V=np.asarray(b.V), ranks=np.asarray(b.ranks), **common(b))
            for b in H.lr_buckets
        ],
    )


def lu_to_matrix(lu, piv) -> np.ndarray:
    """The matrix whose LAPACK-style LU factors (``lu`` with unit lower and
    upper triangles, 0-based row swaps ``piv``) are given."""
    lu = np.asarray(lu)
    M = (np.tril(lu, -1) + np.eye(lu.shape[0])) @ np.triu(lu)
    for i in reversed(range(lu.shape[0])):
        j = int(piv[i])
        if j != i:
            M[[i, j]] = M[[j, i]]
    return M


def geneo_to_numpy(cs) -> dict:
    """A JAX-package GeneoCoarseSpace as the dict that
    ``htool_tpu_torch.convert.geneo_from_numpy`` takes (E rebuilt from its
    LU factors)."""
    d = dict(E=lu_to_matrix(cs.E_lu, np.asarray(cs.E_piv)),
             nu_per_subdomain=np.asarray(cs.nu_per_subdomain),
             eigenvalues=[np.asarray(e) for e in cs.eigenvalues])
    if cs.Z is not None:
        return dict(d, Z=np.asarray(cs.Z))
    return dict(d, Z_loc=np.asarray(cs.Z_loc), row_off=np.asarray(cs.row_off),
                row_size=np.asarray(cs.row_size), nu_max=int(cs.nu_max))


_BLR_FIELDS = ("n", "cell_off", "cell_size", "b", "cls", "dense_slot", "lr_slot", "D", "U", "V",
               "ranks", "piv", "R_half", "epsilon", "factorized", "kind", "permutation")
_BLR2_FIELDS = ("n", "panel_off", "panel_size", "P", "diag_mode", "pU", "pV", "pRank", "Dd",
                "perms", "R", "epsilon", "factorized", "kind", "permutation")


def _field(v):
    return v if v is None or isinstance(v, (int, float, str, bool)) else np.asarray(v)


def blr_to_numpy(B) -> dict:
    """A JAX-package BLRMatrix (factorized or not) as the dict that
    ``htool_tpu_torch.convert.blr_from_numpy`` takes."""
    return {name: _field(getattr(B, name)) for name in _BLR_FIELDS}


def blr2_to_numpy(T) -> dict:
    """A JAX-package TwoLevelBLR (factorized or not, diagonal panels
    dense, flat BLR or nested) as the dict that
    ``htool_tpu_torch.convert.blr2_from_numpy`` takes."""
    d = {name: _field(getattr(T, name)) for name in _BLR2_FIELDS}
    if T.diag is not None:
        d["diag"] = [blr2_to_numpy(p) if hasattr(p, "pU") else blr_to_numpy(p) for p in T.diag]
    return d


def distributed_to_numpy(D) -> dict:
    """A JAX-package DistributedHMatrix as the dict that
    ``htool_tpu_torch.convert.distributed_from_numpy`` takes: every bucket
    array keeps its leading partition axis ``[P, nb, ...]``."""
    d = hmatrix_to_numpy(D)
    del d["t_root_off"]
    return dict(d, n_partitions=int(D.n_partitions), m_loc_max=int(D.m_loc_max),
                part_offsets=np.asarray(D.part_offsets), part_sizes=np.asarray(D.part_sizes))
