"""(1 + i)/(1e-5 + 4π‖x − y‖): Htool-DDM's ``GeneratorTestComplexSymmetric``
(``include/htool/testing/generator_test.hpp:189-196``), regularized so the
diagonal is finite; complex symmetric, not hermitian.  ``kernel(x, y)``
broadcasts over leading dimensions of coordinate tensors ``[..., 3]``; it is
handed to the program's ``KernelGenerator`` (complex64 on float32 points)
and evaluated by the reference, in complex128 there."""

import math

import torch


def kernel(x, y):
    r = torch.sqrt(torch.sum((x - y) ** 2, dim=-1))
    return (1.0 + 1.0j) / (1e-5 + 4.0 * math.pi * r)
