from . import geometry, kernels, problems
from .geometry import create_disk, create_random_points, create_rotated_ellipse, create_sphere
from .kernels import (
    helmholtz_kernel,
    laplace_kernel,
    laplace_kernel_complex,
    laplace_kernel_complex_symmetric,
    laplace_kernel_hermitian,
    laplace_kernel_symmetric,
)
from .problems import grid_laplacian
