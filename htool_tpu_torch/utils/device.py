"""Where the package puts data that arrives without a device.

One rule for every entry point that takes NumPy input (the generators,
``hmatrix_from_dense``, ``hmatrix_from_numpy``, ``load_hmatrix``):

- an explicit ``device`` argument wins;
- a torch tensor keeps its device;
- anything else goes to the default device, which is the GPU
  (``torch.device("cuda")``) unless :func:`set_default_device` named another;
  where no GPU is available this raises and says how to ask for the CPU.

Nothing falls back to the CPU on its own: an H-matrix on the CPU runs the
kernels' plain PyTorch versions, which is what the tests want and never
what a user on a GPU machine wants to get without asking.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["resolve_device", "set_default_device", "get_default_device"]

_default: Optional[torch.device] = None


def set_default_device(device) -> None:
    """Name the device for input that carries none (``None`` restores the
    rule's own default, the GPU).  The CPU test suites call this once with
    ``"cpu"``."""
    global _default
    _default = None if device is None else torch.device(device)


def get_default_device() -> Optional[torch.device]:
    """The device set by :func:`set_default_device`, or ``None``."""
    return _default


def resolve_device(device=None, like=None) -> torch.device:
    """The device for new data: ``device`` if given, else ``like``'s when it
    is a tensor, else the default device (the GPU, or an error without one)."""
    if device is not None:
        return torch.device(device)
    if torch.is_tensor(like):
        return like.device
    if _default is not None:
        return _default
    if not torch.cuda.is_available():
        raise RuntimeError(
            "htool_tpu_torch: the input carries no device and no CUDA device is "
            'available; pass device="cpu" (or call '
            'htool_tpu_torch.set_default_device("cpu")) to work on the CPU')
    return torch.device("cuda")
