from . import geometry, kernels
from .geometry import create_sphere
from .kernels import (
    helmholtz_kernel,
    laplace_kernel,
    laplace_kernel_complex,
    laplace_kernel_complex_symmetric,
    laplace_kernel_hermitian,
    laplace_kernel_symmetric,
)
