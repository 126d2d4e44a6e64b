"""Matrix generators — the user-supplied entry oracle.

Port of ``htool_tpu/generator.py``: a generator exposes a batched gather
``block(rows, cols) -> entries`` where ``rows``/``cols`` are integer index
tensors in *user numbering* with arbitrary leading batch dimensions.  This
is what lets assembly and ACA run over whole buckets of blocks at once.

Under ``jit`` the JAX package fuses ``kernel(tx[..., :, None, :],
sy[..., None, :, :])`` into one loop.  Eager PyTorch materializes the
``[..., m, n, d]`` differences instead, which at the main path's sizes (5k
dense leaves of 256×256; Schwarz local matrices ``[64, 2k, 2k]``) would
take several GB of temporaries.  :meth:`KernelGenerator.block` therefore
evaluates the kernel in chunks of output rows whose temporaries stay under
``_CHUNK_BYTES``.  The differences are taken exactly (no ``torch.cdist``:
its matmul mode cancels near the diagonal of ``1/(1e-5 + 4πr)``).
"""

from __future__ import annotations

from typing import Callable

import torch

from .utils.device import resolve_device

__all__ = [
    "Generator",
    "KernelGenerator",
    "MatrixGenerator",
    "SubsetGenerator",
    "TransposedGenerator",
]

# bytes of kernel-evaluation temporaries per chunk
_CHUNK_BYTES = 1 << 28


def _as_index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, device=device).long()


class Generator:
    """Entry oracle in user numbering.

    Subclasses implement :meth:`block`.  ``rows``: int tensor ``[..., m]``;
    ``cols``: int tensor ``[..., n]`` -> entries ``[..., m, n]``.
    """

    shape: tuple[int, int]
    dtype: torch.dtype
    device: torch.device

    def block(self, rows, cols):
        raise NotImplementedError

    # convenience: full dense materialization (oracle for tests)
    def to_dense(self):
        M, N = self.shape
        return self.block(torch.arange(M, device=self.device),
                          torch.arange(N, device=self.device))


class KernelGenerator(Generator):
    """Generator defined by a coordinate kernel ``k(x, y)``.

    ``kernel`` maps broadcastable coordinate tensors ``[..., d]`` to scalars
    ``[...]`` using torch ops.  Points are NumPy arrays or tensors; they
    live on ``device`` (default: the device of ``target_points`` when it is
    a tensor, else the GPU; see :mod:`.utils.device`), with the dtype they
    were given.
    """

    def __init__(self, kernel: Callable, target_points, source_points,
                 dtype=None, device=None):
        device = resolve_device(device, target_points)
        self.kernel = kernel
        self.target_points = torch.as_tensor(target_points, device=device)
        self.source_points = torch.as_tensor(source_points, device=device)
        self.device = self.target_points.device
        self.shape = (int(self.target_points.shape[0]), int(self.source_points.shape[0]))
        if dtype is None:
            dtype = kernel(self.target_points[:1], self.source_points[:1]).dtype
        self.dtype = dtype

    def block(self, rows, cols):
        rows = _as_index(rows, self.device)
        cols = _as_index(cols, self.device)
        batch = torch.broadcast_shapes(rows.shape[:-1], cols.shape[:-1])
        m, n = rows.shape[-1], cols.shape[-1]
        rows = rows.expand(*batch, m).reshape(-1, m)
        cols = cols.expand(*batch, n).reshape(-1, n)
        B = rows.shape[0]
        out = torch.empty((B, m, n), dtype=self.dtype, device=self.device)
        d = self.target_points.shape[1]
        item = max(self.target_points.element_size(), torch.empty((), dtype=self.dtype).element_size())
        # output rows per chunk: each row takes n·(d + 2) temporaries
        per_chunk = max(1, _CHUNK_BYTES // max(1, n * (d + 2) * item))
        if m <= per_chunk:
            step = max(1, per_chunk // max(m, 1))
            for b0 in range(0, B, step):
                out[b0 : b0 + step] = self._eval(rows[b0 : b0 + step], cols[b0 : b0 + step])
        else:
            for b in range(B):
                for i0 in range(0, m, per_chunk):
                    out[b : b + 1, i0 : i0 + per_chunk] = self._eval(
                        rows[b : b + 1, i0 : i0 + per_chunk], cols[b : b + 1]
                    )
        return out.reshape(*batch, m, n)

    def _eval(self, rows, cols):
        tx = self.target_points[rows]  # [c, m, d]
        sy = self.source_points[cols]  # [c, n, d]
        return self.kernel(tx[:, :, None, :], sy[:, None, :, :]).to(self.dtype)


class SubsetGenerator(Generator):
    """Restriction of a generator to index subsets — the analog of
    ``LocalGeneratorInUserNumberingFromMatrix`` (testing/generator_test.hpp:
    263-277): local index i maps to global user index ``row_index[i]``."""

    def __init__(self, base: Generator, row_index, col_index=None):
        self.base = base
        self.device = base.device
        self.row_index = _as_index(row_index, self.device)
        self.col_index = (
            self.row_index if col_index is None else _as_index(col_index, self.device)
        )
        self.shape = (int(self.row_index.shape[0]), int(self.col_index.shape[0]))
        self.dtype = base.dtype

    def block(self, rows, cols):
        return self.base.block(self.row_index[_as_index(rows, self.device)],
                               self.col_index[_as_index(cols, self.device)])


class TransposedGenerator(Generator):
    """View of a generator's transpose: ``block(r, c) = base.block(c, r)ᵀ``
    (used by the sympartialACA orientation, sympartialACA.hpp:48-63)."""

    def __init__(self, base: Generator):
        self.base = base
        self.shape = (base.shape[1], base.shape[0])
        self.dtype = base.dtype
        self.device = base.device

    def block(self, rows, cols):
        return self.base.block(cols, rows).transpose(-1, -2)


class MatrixGenerator(Generator):
    """Generator backed by a stored dense matrix (user numbering) —
    equivalent of ``GeneratorInUserNumberingFromMatrix``
    (``testing/generator_test.hpp:207-221``)."""

    def __init__(self, matrix, device=None):
        device = resolve_device(device, matrix)
        self.matrix = torch.as_tensor(matrix, device=device)
        self.device = self.matrix.device
        self.shape = tuple(self.matrix.shape)
        self.dtype = self.matrix.dtype

    def block(self, rows, cols):
        rows = _as_index(rows, self.device)
        cols = _as_index(cols, self.device)
        return self.matrix[rows[..., :, None], cols[..., None, :]]
