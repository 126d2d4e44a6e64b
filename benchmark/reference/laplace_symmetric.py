"""1/(1e-5 + 4π‖x − y‖): Htool-DDM's ``GeneratorTestDoubleSymmetric``
(``include/htool/testing/generator_test.hpp:180-187``), regularized so the
diagonal is finite.  ``kernel(x, y)`` broadcasts over leading dimensions of
coordinate tensors ``[..., 3]``; it is handed to the program's
``KernelGenerator`` and evaluated by the reference, in float64 there."""

import math

import torch


def kernel(x, y):
    r = torch.sqrt(torch.sum((x - y) ** 2, dim=-1))
    return 1.0 / (1e-5 + 4.0 * math.pi * r)
