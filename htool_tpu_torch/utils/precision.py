"""Full-precision matmul policy for the compute path.

Counterpart of ``htool_tpu/__init__.py:17-26`` and
``htool_tpu/utils/precision.py``.  The library's accuracy contract is full
f32 arithmetic: compression error < ε (the reference's acceptance test,
``test_hmatrix_build.hpp:191``) breaks under TF32, which keeps about three
decimal digits.  PyTorch runs f32 matmuls in full f32 by default, but cuDNN
allows TF32, and either default can be changed by other code in the
process, so the package pins both when it is imported.

``precise_jit`` has no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import torch

__all__ = ["set_full_precision"]


def set_full_precision() -> None:
    """Pin full-f32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
