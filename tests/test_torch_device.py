"""Where the port puts data that arrives without a device: NumPy input goes
to the GPU or raises (never to the CPU on its own), ``device="cpu"`` works,
a tensor keeps its device."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import htool_tpu_torch as ht
import torch_parity  # noqa: F401  (asks the port for the CPU; undone per test below)
from htool_tpu_torch.convert import hmatrix_from_numpy
from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric
from htool_tpu_torch.utils.device import get_default_device, resolve_device

N = 300


@pytest.fixture
def no_default():
    """The package as a user finds it: no default device set."""
    saved = get_default_device()
    ht.set_default_device(None)
    yield
    ht.set_default_device(saved)


def _numpy_hmatrix_dict():
    pts = create_sphere(N)
    tree = ht.build_cluster_tree(pts, max_leaf_size=32)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts, device="cpu")
    H = ht.build_hmatrix(gen, tree, epsilon=1e-4, eta=10.0)
    d = dict(shape=H.shape, symmetry=H.symmetry, UPLO=H.UPLO, t_root_off=0,
             perm_t=H.perm_t.numpy(), perm_s=H.perm_s.numpy(),
             dense_buckets=[dict(data=b.data.numpy(), t_off=b.t_off.numpy(), s_off=b.s_off.numpy(),
                                 t_sizes=b.t_sizes, s_sizes=b.s_sizes, mirror=b.mirror)
                            for b in H.dense_buckets],
             lr_buckets=[dict(U=b.U.numpy(), V=b.V.numpy(), t_off=b.t_off.numpy(),
                              s_off=b.s_off.numpy(), t_sizes=b.t_sizes, s_sizes=b.s_sizes,
                              ranks=b.ranks, mirror=b.mirror) for b in H.lr_buckets])
    return H, tree, d


ENTRY_POINTS = ["KernelGenerator", "MatrixGenerator", "hmatrix_from_dense", "hmatrix_from_numpy",
                "load_hmatrix"]


def _call(entry, device, tmp_path):
    """Call one entry point on NumPy input; returns the device of what it made."""
    kw = {} if device is None else dict(device=device)
    pts = create_sphere(N)
    if entry == "KernelGenerator":
        return ht.KernelGenerator(laplace_kernel_symmetric, pts, pts, **kw).device
    if entry == "MatrixGenerator":
        return ht.MatrixGenerator(np.eye(8), **kw).device
    H, tree, d = _numpy_hmatrix_dict()
    if entry == "hmatrix_from_dense":
        from htool_tpu_torch.hmatrix.assembly import hmatrix_from_dense

        A = np.random.RandomState(0).randn(N, N)
        return hmatrix_from_dense(A, tree, **kw).device
    if entry == "hmatrix_from_numpy":
        return hmatrix_from_numpy(d, **kw).device
    path = str(tmp_path / "h.npz")
    ht.save_hmatrix(H, path)
    return ht.load_hmatrix(path, **kw).device


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_numpy_input_without_device_raises_without_a_gpu(no_default, tmp_path, entry):
    """No ``device`` and no GPU: the entry point raises and says how to ask
    for the CPU; it does not carry on on the CPU."""
    if torch.cuda.is_available():
        assert _call(entry, None, tmp_path).type == "cuda"
        return
    with pytest.raises(RuntimeError, match=r'pass device="cpu"'):
        _call(entry, None, tmp_path)


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_explicit_cpu_works(no_default, tmp_path, entry):
    assert _call(entry, "cpu", tmp_path) == torch.device("cpu")


def test_tensor_keeps_its_device(no_default):
    """A tensor names its own device: no default is consulted."""
    pts = torch.as_tensor(create_sphere(N))
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    assert gen.device == pts.device == torch.device("cpu")
    assert ht.MatrixGenerator(torch.eye(4)).device == torch.device("cpu")
    meta = torch.empty((4, 4), device="meta")
    assert resolve_device(None, meta) == torch.device("meta")
    assert resolve_device("cpu", meta) == torch.device("cpu")  # an explicit device wins


def test_default_device_setter(no_default):
    """``set_default_device`` is the one switch (the CPU test suites call it
    with "cpu"); ``None`` restores the rule's own default, the GPU."""
    assert get_default_device() is None
    ht.set_default_device("cpu")
    assert resolve_device() == torch.device("cpu")
    assert ht.KernelGenerator(laplace_kernel_symmetric, create_sphere(8),
                              create_sphere(8)).device == torch.device("cpu")
    ht.set_default_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
