"""The port's distributed DDM solve against its replicated solver and the
JAX package's distributed solver.

The JAX package builds the tree (grid Laplacian 8×8×6, P = 4 partitions) and
the distributed operator; both are carried across.  Checks: the halo plan is
the JAX plan, array for array; the halo gather and scatter-add deliver the
owners' values (``tests/test_dist_ddm.py:42-81``); every Schwarz variant
with CG and GMRES takes the replicated ``DDMSolver``'s iteration count with a
true residual < 100·tol (``tests/test_dist_ddm.py:84-96``); one JAX RAS +
GMRES solve matches the port's (same iterations, solutions to rel 1e-8); the
BLR local mode and GenEO, under the three corrections and both stores."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import htool_tpu as hj
import htool_tpu.solvers.dist_ddm as dj
from htool_tpu.parallel import build_distributed_hmatrix as j_build_distributed
from htool_tpu.parallel import default_mesh as j_default_mesh
from htool_tpu.testing import grid_laplacian
import htool_tpu_torch as ht
from htool_tpu_torch.convert import distributed_from_numpy, tree_from_numpy
from htool_tpu_torch.hmatrix.linalg import matvec
from htool_tpu_torch.parallel import build_distributed_hmatrix
from htool_tpu_torch.solvers import (
    DDMSolver,
    DistributedDDMSolver,
    build_geneo_coarse_space,
    build_geometric_overlap,
    build_halo_exchange,
)
from htool_tpu_torch.solvers.dist_ddm import _halo_gather, _halo_scatter_add
from torch_parity import distributed_to_numpy, tree_fields

TOL = 1e-6
NP = 4


@pytest.fixture(scope="module")
def case():
    pts, A = grid_laplacian((8, 8, 6))
    A = np.asarray(A)
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=40, backend="python").build(pts, n_partitions=NP)
    gen_j = hj.MatrixGenerator(A)
    dop_j = j_build_distributed(gen_j, tree_j, j_default_mesh(NP), epsilon=1e-10, eta=10.0)
    tree = tree_from_numpy(tree_fields(tree_j))
    gen = ht.MatrixGenerator(A)
    dop = distributed_from_numpy(distributed_to_numpy(dop_j))
    H = ht.build_hmatrix(gen, tree, epsilon=1e-10, eta=10.0)
    overlap = build_geometric_overlap(tree, 1.5)
    b = np.random.RandomState(1).randn(A.shape[0])
    return dict(A=A, tree_j=tree_j, gen_j=gen_j, dop_j=dop_j, tree=tree, gen=gen, dop=dop, H=H,
                overlap=overlap, b=b)


@pytest.mark.parametrize("radius", [1.5, 2.5])
def test_halo_plan_is_the_reference_plan(case, radius):
    from htool_tpu.solvers.ddm import build_geometric_overlap as j_overlap

    ov_j = j_overlap(case["tree_j"], radius)
    ov = build_geometric_overlap(case["tree"], radius)
    assert all(np.array_equal(a, b) for a, b in zip(ov, ov_j))
    want = dj.build_halo_exchange(case["tree_j"], ov_j)
    got = build_halo_exchange(case["tree"], ov)
    assert got.n_colors > 1 and got.perms == want.perms
    for name in ("P", "m_loc_max", "n_ext_max", "n_colors", "H_max"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("send_idx", "recv_pos", "ext_src", "int_src", "ext_sizes"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)


def _halo_tables(dop, halo):
    return tuple(torch.as_tensor(a, dtype=torch.int64)
                 for a in (halo.send_idx, halo.recv_pos, halo.ext_src))


def test_halo_gather(case):
    """The coloured exchange delivers exactly the owners' interior values into
    each subdomain's overlap positions, zeros past them, and the JAX
    exchange's slices."""
    tree, overlap, dop = case["tree"], case["overlap"], case["dop"]
    halo = build_halo_exchange(tree, overlap)
    N = tree.n_points
    xc = np.random.RandomState(0).randn(N, 2)
    x_loc = dop.to_local_layout(torch.as_tensor(xc)).reshape(NP, dop.m_loc_max, 2)
    send_idx, recv_pos, ext_src = _halo_tables(dop, halo)
    x_ext = _halo_gather(halo, dop.mesh, x_loc, send_idx, recv_pos, ext_src).numpy()
    offs, sizes = tree.partition_offsets_sizes()
    for p in range(NP):
        off, sz = int(offs[p]), int(sizes[p])
        idx = np.concatenate([np.arange(off, off + sz), overlap[p]])
        np.testing.assert_array_equal(x_ext[p, : idx.size], xc[idx])
        assert np.all(x_ext[p, idx.size :] == 0.0)
    # the JAX exchange on the same slices
    halo_j = dj.build_halo_exchange(case["tree_j"], overlap)
    mesh_j, ax = case["dop_j"].mesh, case["dop_j"].axis_name

    def f(x_sl, s, r, e):
        return dj._halo_gather(halo_j, ax, x_sl, s[:, 0], r[:, 0], e[0])

    want = jax.shard_map(f, mesh=mesh_j, in_specs=(P(ax), P(None, ax), P(None, ax), P(ax)),
                         out_specs=P(ax), check_vma=False)(
        jnp.asarray(x_loc.reshape(-1, 2).numpy()), halo_j.send_idx, halo_j.recv_pos,
        halo_j.ext_src)
    np.testing.assert_array_equal(x_ext.reshape(-1, 2), np.asarray(want))


def test_halo_scatter_add(case):
    """The reverse exchange adds every subdomain's overlap values into the
    owners' interior rows, and nothing else."""
    tree, overlap, dop = case["tree"], case["overlap"], case["dop"]
    halo = build_halo_exchange(tree, overlap)
    send_idx, recv_pos, _ = _halo_tables(dop, halo)
    rng = np.random.RandomState(2)
    z_ext = rng.randn(NP, halo.n_ext_max, 3)
    z_int = rng.randn(NP, dop.m_loc_max, 3)
    got = _halo_scatter_add(halo, dop.mesh, torch.as_tensor(z_ext), torch.as_tensor(z_int),
                            send_idx, recv_pos).numpy()
    offs, sizes = tree.partition_offsets_sizes()
    want = z_int.copy()
    for p in range(NP):
        sz = int(sizes[p])
        for j, c in enumerate(overlap[p]):  # cluster row c, ext position sz + j
            q = int(np.searchsorted(offs, c, side="right") - 1)
            want[q, c - int(offs[q])] += z_ext[p, sz + j]
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


def _true_res(A, x, b):
    return np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("krylov", ["cg", "gmres"])
@pytest.mark.parametrize("schwarz", ["none", "jacobi", "asm", "ras"])
def test_dist_matches_replicated(case, krylov, schwarz):
    c = case
    ov = c["overlap"] if schwarz in ("asm", "ras") else None
    _, i_ref = DDMSolver(c["H"], c["gen"], c["tree"], schwarz=schwarz, overlap=ov).solve(
        c["b"], tol=TOL, maxiter=500, krylov=krylov)
    x, infos = DistributedDDMSolver(c["dop"], c["gen"], c["tree"], schwarz=schwarz,
                                    overlap=ov).solve(c["b"], tol=TOL, maxiter=500, krylov=krylov)
    assert infos["Converged"], infos
    assert infos["Nb_it"] == i_ref["Nb_it"], (infos, i_ref)
    assert _true_res(c["A"], x.numpy(), c["b"]) < 100 * TOL
    assert infos["Precond"] == schwarz and infos["Nb_subdomains"] == NP
    assert infos["Local_solver"] == ("-" if schwarz == "none" else "dense")


def test_block_gmres_and_replicated_operator(case):
    """Block GMRES on the partition slices takes the replicated count; the
    replicated DDMSolver accepts the distributed operator (its l2l product)
    and takes the count of the global H-matrix."""
    c = case
    B = np.stack([c["b"], np.random.RandomState(4).randn(len(c["b"]))], axis=1)
    _, i_ref = DDMSolver(c["H"], c["gen"], c["tree"], schwarz="ras", overlap=c["overlap"]).solve(
        B, tol=TOL, maxiter=200, krylov="block_gmres", restart=20)
    x, infos = DistributedDDMSolver(c["dop"], c["gen"], c["tree"], schwarz="ras",
                                    overlap=c["overlap"]).solve(B, tol=TOL, maxiter=200,
                                                                krylov="block_gmres", restart=20)
    assert infos["Nb_it"] == i_ref["Nb_it"] and _true_res(c["A"], x.numpy(), B) < 100 * TOL
    x2, i2 = DDMSolver(c["dop"], c["gen"], c["tree"], schwarz="ras", overlap=c["overlap"]).solve(
        c["b"], tol=TOL, maxiter=200)
    _, i1 = DDMSolver(c["H"], c["gen"], c["tree"], schwarz="ras", overlap=c["overlap"]).solve(
        c["b"], tol=TOL, maxiter=200)
    assert i2["Nb_it"] == i1["Nb_it"] and _true_res(c["A"], x2.numpy(), c["b"]) < 100 * TOL


def test_matches_jax_distributed_solver(case):
    """One RAS + GMRES solve of the JAX package's DistributedDDMSolver and
    of the port's, on the same carried-across operator, tree and overlap."""
    c = case
    ov = [np.asarray(o) for o in c["overlap"]]
    xj, ij = dj.DistributedDDMSolver(c["dop_j"], c["gen_j"], c["tree_j"], schwarz="ras",
                                     overlap=ov).solve(c["b"], tol=TOL, maxiter=200,
                                                       krylov="gmres")
    x, infos = DistributedDDMSolver(c["dop"], c["gen"], c["tree"], schwarz="ras",
                                    overlap=ov).solve(c["b"], tol=TOL, maxiter=200, krylov="gmres")
    assert infos["Nb_it"] == ij["Nb_it"]
    assert np.linalg.norm(x.numpy() - np.asarray(xj)) / np.linalg.norm(np.asarray(xj)) < 1e-8
    assert set(ij) == set(infos)


def test_blr_local_solver(case):
    """Compressed subdomain solves (the LocalHMatrixSolver mode) reproduce
    the dense local solves' iteration count."""
    c = case
    _, i_dense = DistributedDDMSolver(c["dop"], c["gen"], c["tree"], schwarz="ras",
                                      overlap=c["overlap"]).solve(c["b"], tol=TOL, maxiter=500)
    s = DistributedDDMSolver(c["dop"], c["gen"], c["tree"], schwarz="ras", overlap=c["overlap"],
                             local_solver="blr", blr_epsilon=1e-8, blr_block_size=64)
    x, i_blr = s.solve(c["b"], tol=TOL, maxiter=500)
    assert i_blr["Converged"] and i_blr["Nb_it"] == i_dense["Nb_it"], (i_blr, i_dense)
    assert i_blr["Local_solver"] == "blr" and i_blr["BLR_cells"] >= 1
    assert _true_res(c["A"], x.numpy(), c["b"]) < 100 * TOL


@pytest.fixture(scope="module")
def coarse_spaces(case):
    c = case
    A_apply = lambda v: matvec(c["H"], v)  # noqa: E731
    return {store: build_geneo_coarse_space(c["gen"], c["tree"], c["overlap"], A_apply, nu=4,
                                            symmetry="S", store=store)
            for store in ("replicated", "local")}


@pytest.mark.parametrize("correction", ["additive", "deflated", "balanced"])
@pytest.mark.parametrize("store", ["replicated", "local"])
def test_two_level_geneo(case, coarse_spaces, store, correction):
    c = case
    cs = coarse_spaces[store]
    assert (cs.Z is None) == (store == "local")
    _, i_ref = DDMSolver(c["H"], c["gen"], c["tree"], schwarz="ras", overlap=c["overlap"],
                         coarse=coarse_spaces["replicated"],
                         coarse_correction=correction).solve(c["b"], tol=TOL, maxiter=500)
    x, infos = DistributedDDMSolver(c["dop"], c["gen"], c["tree"], schwarz="ras",
                                    overlap=c["overlap"], coarse=cs,
                                    coarse_correction=correction).solve(c["b"], tol=TOL,
                                                                        maxiter=500)
    assert infos["Converged"] and infos["Nb_it"] == i_ref["Nb_it"], (infos, i_ref)
    assert infos["Coarse_size"] == cs.size and infos["Coarse_correction"] == correction
    assert _true_res(c["A"], x.numpy(), c["b"]) < 100 * TOL


def test_kernel_matrix_multi_rhs():
    """The BEM-like kernel flow (examples/use_ddm_solver.cpp) with several
    right-hand sides, CG on 4 partitions, the port's own build."""
    from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

    n = 600
    pts = torch.as_tensor(create_sphere(n))
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    tree = ht.build_cluster_tree(pts.numpy(), max_leaf_size=40, n_partitions=NP)
    dop = build_distributed_hmatrix(gen, tree, epsilon=1e-6, eta=10.0)
    b = np.random.RandomState(0).randn(n, 3)
    x, infos = DistributedDDMSolver(dop, gen, tree, schwarz="ras", overlap_radius=0.2).solve(
        b, tol=TOL, maxiter=300, krylov="cg")
    assert infos["Converged"] and x.shape == (n, 3)
    assert _true_res(gen.to_dense().numpy(), x.numpy(), b) < 100 * TOL


def test_bad_arguments(case):
    c = case
    with pytest.raises(ValueError, match="schwarz variant"):
        DistributedDDMSolver(c["dop"], c["gen"], c["tree"], schwarz="bogus")
    with pytest.raises(ValueError, match="local solver"):
        DistributedDDMSolver(c["dop"], c["gen"], c["tree"], local_solver="bogus")
    s = DistributedDDMSolver(c["dop"], c["gen"], c["tree"], schwarz="jacobi")
    with pytest.raises(ValueError, match="krylov"):
        s.solve(c["b"], krylov="bogus")
