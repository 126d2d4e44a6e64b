"""Native planner bindings: the C++ cluster-tree and block-tree planner,
compiled with g++ at first use and loaded through ctypes.

A copy of ``htool_tpu/native/__init__.py`` (the port imports nothing of
the JAX package) with one change to the build: each process compiles into a
temporary file of its own in the build directory (``tempfile.mkstemp``) and
moves it onto ``libplanner.so`` with ``os.replace``.  Processes that build
at once never write the same file, and a reader finds either no library or a
whole one.

``ClusterTreeBuilder(backend="auto")`` and ``plan_block_tree(backend="auto")``
(the defaults) use this planner when it builds and fall back to the NumPy
planners when it does not; ``backend="native"`` raises instead.  The
``calls`` counts of :func:`ct_build_native` and :func:`bt_plan_native` say
whether a build really went through the library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

__all__ = [
    "native_available",
    "get_lib",
    "build_library",
    "load_library",
    "ct_build_native",
    "bt_plan_native",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "planner.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
_lock = threading.Lock()
_lib = None
_failed = False

_I64 = ctypes.POINTER(ctypes.c_int64)
_F64 = ctypes.POINTER(ctypes.c_double)


def build_library(source: str = SOURCE, out_dir: str = BUILD_DIR) -> str:
    """Compile ``source`` into ``out_dir/libplanner.so`` unless a library at
    least as new as the source is there; returns its path.  Raises when g++
    fails."""
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libplanner.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(source):
        return so
    fd, tmp = tempfile.mkstemp(prefix=".libplanner.", suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", source, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.chmod(tmp, 0o755)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load_library(path: str) -> ctypes.CDLL:
    """Load a built planner library and declare its C interface."""
    lib = ctypes.CDLL(path)
    lib.ct_build.restype = ctypes.c_void_p
    lib.ct_build.argtypes = [ctypes.c_int64, ctypes.c_int, _F64, _F64, _F64, ctypes.c_int64,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _I64,
                             ctypes.c_int]
    lib.ct_n_nodes.restype = ctypes.c_int64
    lib.ct_n_nodes.argtypes = [ctypes.c_void_p]
    lib.ct_n_children_total.restype = ctypes.c_int64
    lib.ct_n_children_total.argtypes = [ctypes.c_void_p]
    lib.ct_is_permutation_local.restype = ctypes.c_int
    lib.ct_is_permutation_local.argtypes = [ctypes.c_void_p]
    lib.ct_fill.restype = None
    lib.ct_fill.argtypes = [ctypes.c_void_p] + [_I64] * 11 + [_F64, _F64]
    lib.ct_free.argtypes = [ctypes.c_void_p]

    tree_args = [_I64] * 8 + [_F64, _F64, ctypes.c_int64, ctypes.c_int64]
    lib.bt_plan.restype = ctypes.c_void_p
    lib.bt_plan.argtypes = tree_args * 2 + [
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.bt_n_dense.restype = ctypes.c_int64
    lib.bt_n_dense.argtypes = [ctypes.c_void_p]
    lib.bt_n_admissible.restype = ctypes.c_int64
    lib.bt_n_admissible.argtypes = [ctypes.c_void_p]
    lib.bt_fill.restype = None
    lib.bt_fill.argtypes = [ctypes.c_void_p, _I64, _I64]
    lib.bt_free.argtypes = [ctypes.c_void_p]
    return lib


def get_lib():
    """The package's planner library, built at first use; ``None`` when g++
    or the load fails (then every later call returns ``None`` at once)."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is None and not _failed:
            try:
                _lib = load_library(build_library())
            except Exception:
                _failed = True
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def _i64p(a):
    return a.ctypes.data_as(_I64)


def _f64p(a):
    return a.ctypes.data_as(_F64)


def ct_build_native(
    points: np.ndarray,
    max_leaf_size: int,
    n_children: int,
    direction: str,
    splitting: str,
    n_partitions: int,
    partition,
    is_partition_local: bool,
    radii,
    weights,
    lib=None,
):
    """Run the native cluster-tree builder of ``lib`` (default: the
    package's own); returns the flat arrays dict, or ``None`` when the
    library is unavailable."""
    lib = lib or get_lib()
    if lib is None:
        return None
    ct_build_native.calls += 1
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n, dim = pts.shape
    rad = None if radii is None else np.ascontiguousarray(radii, np.float64)
    wts = None if weights is None else np.ascontiguousarray(weights, np.float64)
    part = (None if partition is None
            else np.ascontiguousarray(np.asarray(partition).reshape(-1), np.int64))
    h = lib.ct_build(
        n, dim, _f64p(pts),
        _f64p(rad) if rad is not None else None,
        _f64p(wts) if wts is not None else None,
        max_leaf_size, n_children,
        0 if direction == "pca" else 1,
        0 if splitting == "regular" else 1,
        n_partitions,
        _i64p(part) if part is not None else None,
        1 if is_partition_local else 0,
    )
    try:
        nn = lib.ct_n_nodes(h)
        nc = lib.ct_n_children_total(h)
        out = dict(
            permutation=np.empty(n, np.int64),
            offsets=np.empty(nn, np.int64),
            sizes=np.empty(nn, np.int64),
            depths=np.empty(nn, np.int64),
            parents=np.empty(nn, np.int64),
            child_start=np.empty(nn, np.int64),
            child_count=np.empty(nn, np.int64),
            children=np.empty(max(nc, 1), np.int64),
            ranks=np.empty(nn, np.int64),
            counters=np.empty(nn, np.int64),
            partition_roots=np.empty(max(n_partitions, 1), np.int64),
            centers=np.empty((nn, dim), np.float64),
            radii=np.empty(nn, np.float64),
        )
        lib.ct_fill(h, *(_i64p(out[k]) for k in (
            "permutation", "offsets", "sizes", "depths", "parents", "child_start",
            "child_count", "children", "ranks", "counters", "partition_roots")),
            _f64p(out["centers"]), _f64p(out["radii"]))
        out["children"] = out["children"][:nc]
        out["is_permutation_local"] = bool(lib.ct_is_permutation_local(h))
        return out
    finally:
        lib.ct_free(h)


ct_build_native.calls = 0


def _tree_view_args(tree):
    arrs = [np.ascontiguousarray(a, np.int64) for a in (
        tree.offsets, tree.sizes, tree.depths, tree.child_start, tree.child_count,
        tree.children if tree.children.size else np.zeros(1, np.int64),
        tree.ranks, tree.partition_roots)]
    f = [np.ascontiguousarray(tree.centers, np.float64),
         np.ascontiguousarray(tree.radii, np.float64)]
    args = [_i64p(a) for a in arrs] + [_f64p(a) for a in f]
    args += [tree.n_nodes, tree.n_partitions]
    return args, arrs + f  # keep refs alive


def bt_plan_native(
    target_tree,
    source_tree,
    eta: float,
    symmetry: str,
    UPLO: str,
    target_partition: int,
    min_target_depth: int,
    min_source_depth: int,
    consistency: bool,
    leaf_level,
    partition_number_for_symmetry: int = -1,
    lib=None,
):
    """Run the native block-tree planner of ``lib`` (default: the package's
    own); returns ``(dense, admissible)`` [n, 7] int64 arrays, or ``None``
    when the library is unavailable."""
    lib = lib or get_lib()
    if lib is None:
        return None
    bt_plan_native.calls += 1
    ta, _tkeep = _tree_view_args(target_tree)
    sa, _skeep = _tree_view_args(source_tree)
    h = lib.bt_plan(
        *ta, *sa,
        int(target_tree.dim), float(eta),
        {"N": 0, "S": 1, "H": 2}[symmetry],
        {"N": 0, "L": 1, "U": 2}[UPLO],
        int(target_partition), int(min_target_depth), int(min_source_depth),
        1 if consistency else 0,
        -1 if leaf_level is None else int(leaf_level),
        int(partition_number_for_symmetry),
    )
    try:
        nd = lib.bt_n_dense(h)
        na = lib.bt_n_admissible(h)
        dense = np.empty((max(nd, 1), 7), np.int64)
        adm = np.empty((max(na, 1), 7), np.int64)
        lib.bt_fill(h, _i64p(dense), _i64p(adm))
        return dense[:nd], adm[:na]
    finally:
        lib.bt_free(h)


bt_plan_native.calls = 0
