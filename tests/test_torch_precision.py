"""``full_precision()``: the JAX package's context manager for full f32
matmul precision (``htool_tpu/utils/precision.py:28``) in the port, where it
pins "highest" precision and no TF32 within a block and restores the
settings it found."""

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import htool_tpu.utils.precision as pj
import torch_parity  # noqa: F401  (the port on the CPU)
from htool_tpu_torch.utils import full_precision
from htool_tpu_torch.utils.precision import set_full_precision


def _settings():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.mark.parametrize("raises", [False, True])
def test_full_precision_pins_and_restores(raises):
    assert hasattr(pj, "full_precision")
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        before = _settings()
        with pytest.raises(KeyError) if raises else _nothing():
            with full_precision():
                assert _settings() == (False, False, "highest")
                a = torch.randn(64, 64)
                assert torch.equal(a @ torch.eye(64), a)
                if raises:
                    raise KeyError("inside")
        assert _settings() == before
    finally:
        set_full_precision()  # the package's own setting, as at import
    assert _settings() == (False, False, "highest")


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False
