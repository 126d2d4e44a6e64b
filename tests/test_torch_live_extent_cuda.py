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
unplanned kernels, whole blocks) must equal its planned one.  The pair
kernel (every mirror bucket and its mirror in one launch) must equal its
plain version and the per-term kernels on every mirror bucket, for every
cluster size its bucket fits, at k = 1 and 8 and each conjugation.  CUDA
kernels run only on a CUDA device: without one the tests skip.  Run on the
card with

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
            b.plan_t = b.plan_s = b.pair = None


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64", "complex128"])
def test_pair_kernel_matches_plain_and_per_term(card, dtype):
    from htool_tpu_torch.ops import pair_matvec as pm
    from htool_tpu_torch.ops.tiled_matvec import (build_tile_plan, build_tile_plan_lr_split,
                                                  tiled_bucket_matvec)
    import htool_tpu_torch as ht

    H, prepare = _operator(dtype, card)
    prepare(H)
    g = torch.Generator(device=card).manual_seed(2)
    conj = [(False, False)] + ([(True, False), (False, True)] if H.dtype.is_complex else [])
    seen = set()
    for b in H.dense_buckets + H.lr_buckets:
        plan = b.pair
        if not b.mirror:
            continue
        assert isinstance(plan, pm.PairPlan) and b.plan_t is b.plan_s is None, type(plan)
        build = build_tile_plan if isinstance(b, ht.DenseBucket) else build_tile_plan_lr_split
        per_t, per_s = build(b, "t", plan.out_len), build(b, "s", plan.out_len)
        for k in (1, 8):
            KC = pm._kc(k)
            x = torch.randn((plan.out_len, k), dtype=H.dtype, device=card, generator=g)
            item = plan.data.element_size()
            sizes = [c for c in (1, 2, 4, 8) if plan.kind == "lr"
                     and pm._layout(plan, KC, item, c)["smem"] <= pm._SMEM_MAX] or [1]
            for cs in sizes:
                plan.__dict__.pop("_args", None)
                plan.__dict__["_geom"] = {KC: pm._laid_out(plan, KC, cs)}
                for cj_t, cj_s in conj:
                    got = pm.pair_bucket_matvec(plan, x, conj_t=cj_t, conj_s=cj_s)
                    plain = pm.pair_bucket_matvec_reference(plan, x, None, cj_t, cj_s)
                    terms = tiled_bucket_matvec(per_t, x, conj=cj_t)
                    tiled_bucket_matvec(per_s, x, out=terms, conj=cj_s)
                    torch.cuda.synchronize()
                    assert _rel(got, plain) <= TOL[dtype], (plan.kind, k, cs, cj_t, cj_s)
                    assert _rel(got, terms) <= TOL[dtype], (plan.kind, k, cs, cj_t, cj_s)
                    seen.add((plan.kind, cs))
            plan.__dict__.pop("_geom", None)
            plan.__dict__.pop("_args", None)
    assert {"dense", "lr"} <= {kind for kind, _ in seen}
    assert any(cs > 1 for _, cs in seen), seen
