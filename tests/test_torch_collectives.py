"""The port's collectives against ``jax.lax``'s under ``jax.shard_map`` on 4
emulated devices: ``all_gather``, ``psum``, ``psum_scatter(tiled=True)`` and
``ppermute`` (uneven pair sets included), real and complex, over P = 4
partitions in one process; the same calls through a process group (gloo,
world size 1, a file store) give the same tensors; and the mesh's rules."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch.distributed as dist
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import torch_parity  # noqa: F401  (the port on the CPU)
from htool_tpu_torch.parallel import collectives as C
from htool_tpu_torch.parallel.collectives import Mesh

NP = 4
PAIR_SETS = {
    "ring": [(p, (p + 1) % NP) for p in range(NP)],
    "swap": [(0, 1), (1, 0), (2, 3), (3, 2)],
    "uneven": [(3, 0), (1, 2)],  # partitions 1 and 3 receive nothing
    "one": [(2, 1)],
}


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.array(jax.devices()[:NP]), ("p",))


def _data(shape, cplx, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape)
    return x + 1j * rng.randn(*shape) if cplx else x


def _jax(jmesh, fn, x, out_spec):
    return np.asarray(jax.shard_map(fn, mesh=jmesh, in_specs=P("p"), out_specs=out_spec,
                                    check_vma=False)(jnp.asarray(x)))


@pytest.fixture(scope="module")
def gloo_mesh(tmp_path_factory):
    """A mesh of 4 partitions through a gloo group of world size 1."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        yield Mesh(NP, "cpu", group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def _meshes(gloo_mesh):
    return (Mesh(NP, "cpu"), gloo_mesh)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_all_gather(jmesh, gloo_mesh, cplx):
    x = _data((NP, 5, 3), cplx)
    want = _jax(jmesh, lambda a: jax.lax.all_gather(a[0], "p"), x, P())
    for mesh in _meshes(gloo_mesh):
        np.testing.assert_array_equal(C.all_gather(torch.as_tensor(x), mesh).numpy(), want)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_psum(jmesh, gloo_mesh, cplx):
    x = _data((NP, 6, 2), cplx, seed=1)
    want = _jax(jmesh, lambda a: jax.lax.psum(a[0], "p"), x, P())
    for mesh in _meshes(gloo_mesh):
        got = C.psum(torch.as_tensor(x), mesh).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("route", ["all_reduce", "reduce_scatter_tensor"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_psum_scatter(jmesh, gloo_mesh, monkeypatch, cplx, route):
    m, k = 3, 2
    x = _data((NP, NP * m, k), cplx, seed=2)
    want = _jax(jmesh, lambda a: jax.lax.psum_scatter(a[0], "p", scatter_dimension=0,
                                                      tiled=True), x, P("p"))
    monkeypatch.setattr(C, "reduce_scatter_route", lambda backend: route)
    for mesh in _meshes(gloo_mesh):
        got = C.psum_scatter(torch.as_tensor(x), mesh)
        assert tuple(got.shape) == (NP, m, k)
        np.testing.assert_allclose(got.reshape(NP * m, k).numpy(), want, rtol=1e-15,
                                   atol=1e-15)


def test_reduce_scatter_route_by_backend():
    """NCCL reduces and scatters in one call; gloo, which may lack
    ``reduce_scatter_tensor``, takes an ``all_reduce`` and a slice."""
    assert C.reduce_scatter_route("nccl") == "reduce_scatter_tensor"
    assert C.reduce_scatter_route("gloo") == "all_reduce"


@pytest.mark.parametrize("pairs", list(PAIR_SETS), ids=list(PAIR_SETS))
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_ppermute(jmesh, gloo_mesh, cplx, pairs):
    x = _data((NP, 4, 2), cplx, seed=3)
    perm = PAIR_SETS[pairs]
    want = _jax(jmesh, lambda a: jax.lax.ppermute(a, "p", perm), x, P("p"))
    for mesh in _meshes(gloo_mesh):
        np.testing.assert_array_equal(C.ppermute(torch.as_tensor(x), perm, mesh).numpy(), want)


def test_mesh_rules(gloo_mesh, monkeypatch):
    m = Mesh(8, "cpu")
    assert (m.n_local, m.lo, m.hi, m.world_size, m.backend) == (8, 0, 8, 1, None)
    assert gloo_mesh.backend == "gloo" and gloo_mesh.n_local == NP
    # rank 1 of a group of 3 holds partitions [2, 4) of 6; 4 do not split over 3
    monkeypatch.setattr(C.dist, "get_world_size", lambda group: 3)
    monkeypatch.setattr(C.dist, "get_rank", lambda group: 1)
    m = Mesh(6, "cpu", group="a group of 3")
    assert (m.n_local, m.lo, m.hi, m.owner(5)) == (2, 2, 4, 2)
    with pytest.raises(ValueError, match="multiple of the world size"):
        Mesh(4, "cpu", group="a group of 3")
