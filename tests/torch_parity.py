"""Helpers for the parity tests of the PyTorch port: turn JAX-package objects
into the plain NumPy dicts that ``htool_tpu_torch.convert`` takes.

Importing this module also asks the port for the CPU: its entry points put
NumPy input on the GPU unless told otherwise, and these tests run without
one.  Every ``tests/test_torch_*.py`` imports it."""

import dataclasses

import numpy as np

import htool_tpu_torch

htool_tpu_torch.set_default_device("cpu")


def tree_fields(tree) -> dict:
    """All fields of a JAX-package ClusterTree as NumPy arrays / scalars."""
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}


def hmatrix_to_numpy(H) -> dict:
    """The JAX HMatrix's structure and buckets as NumPy arrays."""

    def common(b):
        return dict(
            t_off=np.asarray(b.t_off), s_off=np.asarray(b.s_off),
            t_sizes=np.asarray(b.t_sizes), s_sizes=np.asarray(b.s_sizes),
            mirror=bool(b.mirror),
        )

    return dict(
        shape=tuple(H.shape), symmetry=H.symmetry, UPLO=H.UPLO,
        t_root_off=int(H.t_root_off),
        perm_t=np.asarray(H.perm_t), perm_s=np.asarray(H.perm_s),
        dense_buckets=[dict(data=np.asarray(b.data), **common(b)) for b in H.dense_buckets],
        lr_buckets=[
            dict(U=np.asarray(b.U), V=np.asarray(b.V), ranks=np.asarray(b.ranks), **common(b))
            for b in H.lr_buckets
        ],
    )
