"""Build and load the package's hand-written CUDA kernels.

The sources in ``htool_tpu_torch/csrc/*.cu`` export a plain C interface.
At first use, :func:`load_library` compiles them with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, links
the objects into one shared library under ``kernels/_build/`` (or the
directory that the environment variable ``HTOOL_TPU_TORCH_KERNEL_DIR``
names) and loads it with ``ctypes``.  The library's file name carries a
hash of the sources and flags, so an edited source is rebuilt and a built
one is reused.
Nothing is compiled when the package is imported: CPU tensors never reach
the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load_library", "build_library", "build_info", "check", "entry_point", "count_launch",
           "launch", "SUFFIX_OF"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(os.environ.get("HTOOL_TPU_TORCH_KERNEL_DIR")
              or Path(__file__).resolve().parent / "_build")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# entry-point suffix of each scalar type the kernels are compiled for
# (torch is imported by the callers, not here: the keys are dtype names)
SUFFIX_OF = {"float32": "_f32", "float64": "_f64", "complex64": "_c64",
             "complex128": "_c128"}

# filled by the first load: seconds, library path, ptxas report, and whether
# that load compiled the library (``compiled``) or found it built
build_info: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        "htool_stream_matvec": [ci, ci, ci, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp, vp, ci,
                                ci, vp, ci, vp, vp],
        "htool_lr_bucket_stream": [ci, ci, vp, vp, ci, ci, ci, ci, vp, vp, ll, ll, vp, ll, ci,
                                   vp, ll, vp, ci, ci, ci, ci, ci, ci, ci, vp],
        "htool_dense_bucket_stream": [ci, ci, vp, ci, ci, ci, vp, vp, ll, ll, vp, ll, ci, vp,
                                      ll, ci, ci, ci, vp],
        "htool_pair_matvec": [ci, vp, vp, vp, vp, ci, ci, vp, ci, vp, vp],
    }
    for base, argtypes in signatures.items():
        for suffix in SUFFIX_OF.values():
            fn = getattr(lib, base + suffix)
            fn.argtypes = argtypes
            fn.restype = ci
    lib.htool_pair_geom_ints.argtypes = []
    lib.htool_pair_geom_ints.restype = ci
    lib.htool_cuda_error_string.argtypes = [ci]
    lib.htool_cuda_error_string.restype = ctypes.c_char_p


def build_library() -> tuple:
    """Compile the sources and return ``(path of the shared library, path of
    the compiler's log, whether it compiled now)``.  A library built before
    in the same directory with the same sources and flags is reused."""
    srcs = _sources()
    flags = _NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = _BUILD / f"libhtool_kernels_{h.hexdigest()[:16]}.so"
    log = so.with_suffix(".log")
    compiled = not so.exists()
    if compiled:
        _BUILD.mkdir(parents=True, exist_ok=True)
        # build in a temporary directory and rename, so a concurrent or
        # interrupted build never leaves a partial library under the final name
        with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
            nvcc = _nvcc()
            objs, procs = [], []
            for src in (s for s in srcs if s.suffix == ".cu"):
                objs.append(os.path.join(tmp, src.stem + ".o"))
                procs.append(subprocess.Popen(
                    [nvcc, *flags, "-I", str(_CSRC), "-c", "-o", objs[-1], str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ))
            text = "".join(p.communicate()[0] for p in procs)
            ok = all(p.returncode == 0 for p in procs)
            if ok:
                lib_tmp = os.path.join(tmp, so.name)
                link = subprocess.run([nvcc, "-shared", "-o", lib_tmp, *objs],
                                      capture_output=True, text=True)
                text += link.stdout + link.stderr
                ok = link.returncode == 0
            log.write_text(text)
            if not ok:
                raise RuntimeError(f"nvcc failed:\n{text}")
            os.replace(lib_tmp, so)
    return so, log, compiled


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    t0 = time.perf_counter()
    so, log, compiled = build_library()
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    build_info.update(
        seconds=time.perf_counter() - t0,
        library=str(so),
        compiled=compiled,
        ptxas=log.read_text() if log.exists() else "",
    )
    return lib


@functools.lru_cache(maxsize=None)
def entry_point(base: str, dtype):
    """The library's function ``base`` for a torch dtype (building the
    library at first use); raises ``TypeError`` for a dtype the kernels are
    not compiled for."""
    suffix = SUFFIX_OF.get(str(dtype).removeprefix("torch."))
    if suffix is None:
        raise TypeError(f"{base}: the kernel takes float32, float64, complex64 or "
                        f"complex128, got {dtype}")
    return getattr(load_library(), base + suffix)


def _raw_stream(index: int) -> int:
    """The handle of PyTorch's current stream on device ``index``."""
    import torch

    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:  # no Stream object is built: a wrapper call is mostly host time
        return get(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(fn, device, *args) -> None:
    """Call the library function ``fn(*args, stream)`` on PyTorch's current
    stream of ``device`` and raise if the launch was refused.  ``device`` is
    made current for the call when it is not (a raw launch goes to the
    current device)."""
    import torch

    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        code = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*args, _raw_stream(index))
    if code != 0:
        check(code)


def count_launch(wrapper, dtype, k: int) -> None:
    """Add one bucket term that went to the GPU to a wrapper's counts:
    ``wrapper.launches``, ``wrapper.launches_by_dtype[dtype]`` and
    ``wrapper.launches_by_k[(dtype, k)]`` (k right-hand-side columns)."""
    wrapper.launches += 1
    wrapper.launches_by_dtype[dtype] = wrapper.launches_by_dtype.get(dtype, 0) + 1
    wrapper.launches_by_k[(dtype, k)] = wrapper.launches_by_k.get((dtype, k), 0) + 1


def check(code: int) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if code != 0:
        msg = load_library().htool_cuda_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} (error {code})")
