"""The planned product kernels read nothing past each block's live extent,
on the card.

A symmetric H-matrix of a sphere ('S', 'L') in float32, float64, complex64
and complex128, with the planned products (split two-stage plans on every
low-rank bucket).  Every stored entry outside
each block's live extent (rows and columns past its true sizes, rank columns
of U and rank rows of V past its true rank) is set to NaN in a copy: the
copy's planned product must stay finite and equal the original's within
float tolerance, at k = 1 and k = 8 (float64 and complex128 on the FP64
tensor cores there), N and T.  The original's product without plans (the
unplanned kernels, whole blocks) must equal its planned one.  CUDA kernels
run only on a CUDA device: without one the tests skip.  Run on the card with

    python -m pytest tests/test_torch_live_extent_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TOL = {"float32": 1e-5, "complex64": 1e-5, "float64": 1e-12, "complex128": 1e-12}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the product kernels run only on the card")
    return torch.device("cuda", 0)


def _operator(dtype: str, device):
    import htool_tpu_torch as ht
    from htool_tpu_torch.hmatrix.linalg import prepare_tiled_matvec
    from htool_tpu_torch.testing import (
        create_sphere,
        laplace_kernel_complex_symmetric,
        laplace_kernel_symmetric,
    )

    real = np.float32 if dtype in ("float32", "complex64") else np.float64
    kernel = laplace_kernel_complex_symmetric if "complex" in dtype else laplace_kernel_symmetric
    pts = create_sphere(12_000, seed=5)
    pts_d = torch.as_tensor(pts.astype(real), device=device)
    gen = ht.KernelGenerator(kernel, pts_d, pts_d)
    tree = ht.build_cluster_tree(pts, max_leaf_size=100)
    H = ht.build_hmatrix(gen, tree, epsilon=1e-3, eta=10.0, symmetry="S", UPLO="L")
    assert str(H.dtype) == f"torch.{dtype}"
    return H, prepare_tiled_matvec


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64", "complex128"])
def test_nan_padding_is_never_read(card, dtype):
    from htool_tpu_torch.hmatrix.linalg import matvec
    from htool_tpu_torch.testing import fill_padding

    H, prepare = _operator(dtype, card)
    poisoned = prepare(fill_padding(H, float("nan")))
    g = torch.Generator(device=card).manual_seed(1)
    for k in (1, 8):
        x = torch.randn((H.shape[1], k), dtype=H.dtype, device=card, generator=g)
        unplanned = {op: matvec(H, x, op=op) for op in ("N", "T")}  # whole blocks
        prepare(H)
        for op in ("N", "T"):
            want = matvec(H, x, op=op)
            got = matvec(poisoned, x, op=op)
            torch.cuda.synchronize()
            assert torch.isfinite(torch.view_as_real(got) if got.is_complex() else got).all()
            assert _rel(got, want) <= TOL[dtype], (op, k)
            assert _rel(unplanned[op], want) <= TOL[dtype], (op, k)
        for b in H.dense_buckets + H.lr_buckets:  # back to the unplanned kernels
            b.plan_t = b.plan_s = None
