"""Unplanned bucket matvec: Hopper kernel wrappers and their plain versions.

Port of ``htool_tpu/ops/bucket_matvec.py`` (``dense_bucket_matvec``,
``lr_bucket_matvec``).  One call applies one bucket term of an H-matrix
product without a tiled plan::

    y[out_off[i] - out_root : + out_w] += op(B_i) · x[in_off[i] - in_root : + in_w]

for every block B_i of the bucket: a dense block ``data[i]`` or a low-rank
block ``U[i] @ V[i]``, with op = B_i, B_iᵀ when ``trans``, conj(B_i) when
``conj``, B_iᴴ with both (for a low-rank block ``conj`` conjugates U and V;
the mirrored terms of hermitian storage need these modes).  The offsets
are the bucket's own ``t_off``/``s_off``; ``in_root``/``out_root`` are the
root offsets a partition-restricted block row subtracts on its local side.

The Pallas kernels walk the blocks on a sequential grid with x and y
resident in VMEM.  The Hopper kernels add into y with atomics and stream
the blocks through shared memory (``htool_tpu_torch/csrc/bucket_stream.cu``
over ``csrc/matvec_stream.cuh``), with the work cut by bytes
(:func:`..ops.cut.cut_rule`: P panels per block along the output dimension,
G panels per CTA), so the grid is ``(nb·P/G, k chunks)`` whatever the
bucket.  A dense term is one launch over its blocks.  A low-rank term runs
in two stages, ``t = op(V)·x`` (``op(U)ᵀ·x`` when transposed) into a
staging tensor ``[nb·r_pad, k]`` that the wrapper allocates, then
``y += op(U)·t``, each stage cut by the same rule; a term so short that the
second launch costs more than the streaming saves
(:func:`..ops.cut.lr_split_wanted`, by the bytes of a block and of the
bucket and by k) runs one block per CTA in one launch
(``csrc/bucket_matvec.cu``, through a shared-memory intermediate).  Not
ported: the VMEM gate ``pallas_matvec_ok`` and the ``HTOOL_TPU_PALLAS``
switch.

The wrappers take float32, float64, complex64 or complex128 blocks of the
same dtype as x; the complex kernels read interleaved entries as PyTorch
stores them.  CPU tensors run the plain version (gather → ``bmm`` →
``index_add_``); CUDA tensors launch the kernel or raise; other devices and
other dtypes raise.
Each term that goes to the GPU adds one to the wrapper's ``launches`` and to
its ``launches_by_dtype[dtype]``, and its CUDA launches (two for a two-stage
term) to ``cuda_launches``; a bucket with no blocks launches nothing.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .cut import cut_rule, lr_split_wanted, lr_stage_shapes, staging_rows

__all__ = [
    "dense_bucket_matvec",
    "dense_bucket_matvec_reference",
    "lr_bucket_matvec",
    "lr_bucket_matvec_reference",
]

_KERNEL_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def _rows(off: torch.Tensor, root: int, width: int, device) -> torch.Tensor:
    """[nb, width] rows of each block's window."""
    return (off.to(device) - root)[:, None] + torch.arange(width, device=device)


def _accumulate(out, out_len, x_pad, out_off, out_root, contrib):
    y = out if out is not None else torch.zeros(
        (out_len, x_pad.shape[1]), dtype=x_pad.dtype, device=x_pad.device)
    idx = _rows(out_off, out_root, contrib.shape[1], x_pad.device).reshape(-1)
    return y.index_add_(0, idx, contrib.reshape(-1, x_pad.shape[1]))


def dense_bucket_matvec_reference(data, in_off, out_off, x_pad, trans: bool, out_len: int,
                                  *, in_root: int = 0, out_root: int = 0,
                                  out: Optional[torch.Tensor] = None, conj: bool = False):
    """Plain PyTorch version of :func:`dense_bucket_matvec`: gather the
    input windows, batched matmul, ``index_add_`` into y.  ``conj`` applies
    conj(D_i) (complex products: mode 'C' is trans + conj, 'conj' is conj)."""
    bm, bn = data.shape[1], data.shape[2]
    D = data.to(x_pad.dtype)
    if conj:
        D = D.conj()
    xg = x_pad[_rows(in_off, in_root, bm if trans else bn, x_pad.device)]
    return _accumulate(out, out_len, x_pad, out_off, out_root,
                       (D.transpose(1, 2) if trans else D) @ xg)


def lr_bucket_matvec_reference(U, V, in_off, out_off, x_pad, trans: bool, out_len: int,
                               *, in_root: int = 0, out_root: int = 0,
                               out: Optional[torch.Tensor] = None, conj: bool = False):
    """Plain PyTorch version of :func:`lr_bucket_matvec`: ``U (V x)``, or
    ``Vᵀ (Uᵀ x)`` when ``trans``, on gathered windows, ``index_add_`` into
    y.  ``conj`` conjugates both factors."""
    bm, bn = U.shape[1], V.shape[2]
    U, V = U.to(x_pad.dtype), V.to(x_pad.dtype)
    if conj:
        U, V = U.conj(), V.conj()
    xg = x_pad[_rows(in_off, in_root, bm if trans else bn, x_pad.device)]
    contrib = V.transpose(1, 2) @ (U.transpose(1, 2) @ xg) if trans else U @ (V @ xg)
    return _accumulate(out, out_len, x_pad, out_off, out_root, contrib)


def _checked(name, blocks, in_off, out_off, x_pad, out_len, out):
    """Validate the operands; returns (y, k) with y the output to add into."""
    dtype = x_pad.dtype
    if dtype not in _KERNEL_DTYPES or any(b.dtype != dtype for b in blocks):
        raise TypeError(f"{name}: takes float32/float64/complex64/complex128 blocks of "
                        f"x's dtype, got blocks {blocks[0].dtype} and x {dtype}")
    if x_pad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x_pad.device}")
    nb = int(blocks[0].shape[0])
    if (x_pad.ndim != 2 or any(b.ndim != 3 or b.shape[0] != nb for b in blocks)
            or tuple(in_off.shape) != (nb,) or tuple(out_off.shape) != (nb,)
            or (len(blocks) == 2 and blocks[0].shape[2] != blocks[1].shape[1])):
        raise ValueError(f"{name}: expected [nb, ·, ·] blocks, [nb] offsets and a "
                         "[L, k] x_pad")
    k = int(x_pad.shape[1])
    if out is not None and (tuple(out.shape) != (out_len, k) or out.dtype != dtype
                            or out.device != x_pad.device):
        raise ValueError(f"{name}: out must be a {dtype} [{out_len}, {k}] tensor "
                         f"on {x_pad.device}")
    if x_pad.device.type == "cpu":
        return out, k
    if out is None:
        out = torch.zeros((out_len, k), dtype=dtype, device=x_pad.device)
    for t in (*blocks, in_off, out_off, x_pad, out):
        if t.device != x_pad.device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous and on {x_pad.device}")
    if in_off.dtype != torch.int64 or out_off.dtype != torch.int64:
        raise TypeError(f"{name}: offsets must be int64")
    return out, k


def _launch(wrapper, base, args, x_pad, cuda_launches=1):
    from ..kernels import count_launch, entry_point, launch

    launch(entry_point(base, x_pad.dtype), x_pad.device, *args)
    count_launch(wrapper, x_pad.dtype, int(x_pad.shape[1]))
    wrapper.cuda_launches += cuda_launches


def dense_bucket_matvec(data, in_off, out_off, x_pad, trans: bool, out_len: int,
                        *, in_root: int = 0, out_root: int = 0,
                        out: Optional[torch.Tensor] = None,
                        conj: bool = False) -> torch.Tensor:
    """One dense bucket term: data [nb, bm, bn], int64 offsets [nb], x_pad
    [L, k]; ``conj`` applies conj(data).  Returns y [out_len, k], added into
    ``out`` when it is given."""
    y, k = _checked("dense_bucket_matvec", [data], in_off, out_off, x_pad, out_len, out)
    if x_pad.device.type == "cpu":
        return dense_bucket_matvec_reference(data, in_off, out_off, x_pad, trans, out_len,
                                             in_root=in_root, out_root=out_root, out=out,
                                             conj=conj)
    nb, bm, bn = (int(s) for s in data.shape)
    if nb == 0 or k == 0:
        return y
    _launch(dense_bucket_matvec, "htool_dense_bucket_stream",
            (int(trans), int(bool(conj)), data.data_ptr(), nb, bm, bn, in_off.data_ptr(),
             out_off.data_ptr(), int(in_root), int(out_root), x_pad.data_ptr(),
             int(x_pad.shape[0]), k, y.data_ptr(), int(out_len),
             *_dense_route(nb, bm, bn, data.element_size(), bool(trans))), x_pad)
    return y


def lr_bucket_matvec(U, V, in_off, out_off, x_pad, trans: bool, out_len: int,
                     *, in_root: int = 0, out_root: int = 0,
                     out: Optional[torch.Tensor] = None,
                     conj: bool = False, split: Optional[bool] = None) -> torch.Tensor:
    """One low-rank bucket term: U [nb, bm, r], V [nb, r, bn], int64 offsets
    [nb], x_pad [L, k]; ``conj`` conjugates both factors.  Returns y
    [out_len, k], added into ``out`` when it is given.  ``split`` forces the
    two-stage (True) or the one-launch (False) kernel; by default
    :func:`..ops.cut.lr_split_wanted` decides from the shape and k."""
    y, k = _checked("lr_bucket_matvec", [U, V], in_off, out_off, x_pad, out_len, out)
    if x_pad.device.type == "cpu":
        return lr_bucket_matvec_reference(U, V, in_off, out_off, x_pad, trans, out_len,
                                          in_root=in_root, out_root=out_root, out=out,
                                          conj=conj)
    nb, bm, r = (int(s) for s in U.shape)
    bn = int(V.shape[2])
    if nb == 0 or k == 0 or r == 0:
        return y
    common = (int(trans), int(bool(conj)), U.data_ptr(), V.data_ptr(), nb, bm, bn, r,
              in_off.data_ptr(), out_off.data_ptr(), int(in_root), int(out_root),
              x_pad.data_ptr(), int(x_pad.shape[0]), k, y.data_ptr(), int(out_len))
    route = _lr_route(nb, bm, bn, r, U.element_size(), bool(trans), split, k)
    if route is None:
        _launch(lr_bucket_matvec, "htool_lr_bucket_matvec", common, x_pad)
        return y
    t = torch.empty((nb * route[0], k), dtype=x_pad.dtype, device=x_pad.device)
    _launch(lr_bucket_matvec, "htool_lr_bucket_stream", common + (t.data_ptr(), *route), x_pad,
            cuda_launches=2)
    return y


@functools.lru_cache(maxsize=None)
def _dense_route(nb, bm, bn, item, trans):
    """The cut (P, cut, G) of a dense bucket's blocks: depends only on its
    shape."""
    return tuple(cut_rule(nb, bm, bn, item, trans))


@functools.lru_cache(maxsize=None)
def _lr_route(nb, bm, bn, r, item, trans, split, k):
    """What depends only on a low-rank bucket's shape and on k: ``None`` for
    the one-launch kernel, else ``(r_pad, P, cut, G of stage A, P, cut, G of
    stage B)`` for the two-stage one."""
    if split is None:
        split = lr_split_wanted(nb, bm, bn, r, item, k)
    if not split:
        return None
    stages = []
    for rows, cols in lr_stage_shapes(bm, bn, r, trans):
        stages += cut_rule(nb, rows, cols, item, trans)
    return (staging_rows(r), *stages)


dense_bucket_matvec.launches = 0
dense_bucket_matvec.cuda_launches = 0
dense_bucket_matvec.launches_by_dtype = {}
dense_bucket_matvec.launches_by_k = {}
lr_bucket_matvec.launches = 0
lr_bucket_matvec.cuda_launches = 0
lr_bucket_matvec.launches_by_dtype = {}
lr_bucket_matvec.launches_by_k = {}
