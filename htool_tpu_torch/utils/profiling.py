"""Profiling hooks — wall-clock phase timers, the program's spans and
counters, and device traces.

Port of ``htool_tpu/utils/profiling.py``.  The reference records wall-clock
phase timings in info maps (``tree_builder.hpp:308-316``,
``ddm.hpp:66-122``); this package does the same (``HMatrix.info``, solver
``infos``, the GenEO infos) and adds a device trace through
``torch.profiler`` (CPU and CUDA activities, a Chrome trace).

Spans (:func:`span`) mark the program's own phases: the Krylov steps and
their waits, the product, the Schwarz apply, ACA, the overlap and the local
inverses (names ``htool.*``).  They are on only while a torch profiler
records (``device_trace``, or any ``torch.profiler.profile``): each is then
a ``record_function`` on the profiler's clock, and a record in memory that
:func:`spans` returns.  With no profiler active a span site is one flag
check and records nothing.  Counters (:func:`count`) are always on.  The
recorder and the counters are one per process, like the kernel wrappers'
launch counts, and spans nest in the order one thread opens them.  While
the current CUDA stream is capturing a graph, spans are off: a capture does
no work, and a CUDA event cannot be recorded into it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["device_trace", "Timer", "annotate", "span", "count", "counters", "spans", "clear",
           "dropped", "self_times", "tallies", "add_tallies", "MAX_SPANS"]


@contextlib.contextmanager
def device_trace(log_dir: str, host_profile: bool = False):
    """Trace the enclosed block into ``log_dir/trace.json`` (Chrome trace
    format, readable by ``chrome://tracing`` and Perfetto)::

        with device_trace("traces/matvec"):
            y = matvec(H, x)

    CUDA activities are recorded where a GPU is available; the trace is
    written after the device has finished the block's work.  With
    ``host_profile``, each host event also records the Python stack that
    issued it (``with_stack``: a ``stack`` field in the trace,
    ``key_averages(group_by_stack_n=...)``), at the cost of slower host
    code while tracing.  The program's ``htool.*`` spans are on inside the
    block (:func:`span`; read them with :func:`spans`).  Yields the
    ``torch.profiler.profile`` object (``key_averages()`` and the like)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, with_stack=host_profile) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(sync) -> None:
    device = sync if isinstance(sync, torch.device) else getattr(sync, "device", None)
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# spans and counters

MAX_SPANS = 100_000  # records kept; later spans are counted in dropped()

_profiler_on = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_records: list = []  # records in order of start, finished or open
_open: list = []  # the open spans' records, outermost first
_ids = itertools.count(1)
_dropped = 0
_counters: dict = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process counter ``name`` (always on)."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """The process counters: {name: count}."""
    return dict(_counters)


def _launches() -> int:
    """CUDA launches of the product's kernel wrappers so far (their own
    ``cuda_launches`` counts)."""
    return sum(fn.cuda_launches for fn in _tallied()[:-1])


def _totals() -> dict:
    from ..hmatrix.linalg import matvec

    return dict(_counters, launches=_launches(), products=matvec.products)


def _tallied() -> tuple:
    """The functions that keep counts on themselves: the product's kernel
    wrappers (launches by dtype and by k, CUDA launches), then the product
    (``matvec.products``)."""
    from ..hmatrix.linalg import matvec
    from ..ops.bucket_matvec import dense_bucket_matvec, lr_bucket_matvec
    from ..ops.pair_matvec import pair_bucket_matvec
    from ..ops.tiled_matvec import tiled_bucket_matvec

    return (tiled_bucket_matvec, dense_bucket_matvec, lr_bucket_matvec, pair_bucket_matvec,
            matvec)


def tallies() -> dict:
    """Every count the program keeps, flat: ``(None, name)`` for each
    process counter (:func:`count`), ``(fn, attribute)`` for an int that a
    wrapper or the product keeps on itself and ``(fn, attribute, key)`` for
    an entry of such a dict of ints.  A CUDA graph that repeats work records
    what its capture counted (the change of :func:`tallies`) and adds it at
    each replay (:func:`add_tallies`)."""
    out = {(None, name): n for name, n in _counters.items()}
    for fn in _tallied():
        for attr, v in vars(fn).items():
            if isinstance(v, int):
                out[(fn, attr)] = v
            elif isinstance(v, dict):
                out.update(((fn, attr, key), n) for key, n in v.items() if isinstance(n, int))
    return out


def add_tallies(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` times each count of ``delta`` (keys as :func:`tallies`
    gives them) to the program's counts."""
    for key, n in delta.items():
        if key[0] is None:
            count(key[1], sign * n)
        elif len(key) == 2:
            setattr(key[0], key[1], getattr(key[0], key[1]) + sign * n)
        else:
            d = getattr(key[0], key[1])
            d[key[2]] = d.get(key[2], 0) + sign * n


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


class _Span:
    """A span while the profiler records: a ``record_function`` and a record."""

    __slots__ = ("name", "sync", "device", "rf", "rec", "base", "events")

    def __init__(self, name, sync, device):
        self.name, self.sync, self.device = name, sync, device
        self.events = None

    def __enter__(self):
        global _dropped
        self.rf = record_function(self.name)
        self.rf.__enter__()
        parent = _open[-1] if _open else None
        i = next(_ids)
        self.rec = rec = {"name": self.name, "id": i,
                          "parent": None if parent is None else parent["id"],
                          "root": i if parent is None else parent["root"], "t0": 0, "t1": None}
        self.base = _totals() if parent is None else None
        if self.device is not None:
            dev = getattr(self.device, "device", self.device)
            if dev.type == "cuda":
                stream = torch.cuda.current_stream(dev)
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True), stream)
                self.events[0].record(stream)
        if len(_records) < MAX_SPANS:
            _records.append(rec)
        else:
            _dropped += 1
        _open.append(rec)
        rec["t0"] = time.perf_counter_ns()

    def __exit__(self, *exc):
        rec = self.rec
        try:
            if self.sync is not None:
                _synchronize(self.sync)
            if self.events is not None:
                start, end, stream = self.events
                end.record(stream)
                rec["_events"] = (start, end)
            rec["t1"] = time.perf_counter_ns()
            if self.device is not None and self.events is None:
                rec["device_us"] = (rec["t1"] - rec["t0"]) / 1e3  # the host did the work
            if self.base is not None:
                now = _totals()
                rec["counters"] = {k: v - self.base.get(k, 0) for k, v in now.items()}
        finally:
            _open.pop()
            self.rf.__exit__(*exc)
        return False


def span(name: str, *, sync=None, device=None):
    """A named span of the program, as a context manager::

        with span("htool.schwarz.apply", device=r):
            ...

    Off (no torch profiler active) it is a shared no-op context: nothing is
    allocated, synchronized or recorded.  On, it opens a ``record_function``
    of the same name and records ``name``, ``id``, ``parent`` (the
    enclosing span's id, or None), ``root`` (the outermost enclosing span's
    id, its own for a root) and ``t0``/``t1`` (``time.perf_counter_ns``).  A
    root span also records ``counters``: the change of every process counter
    (:func:`count`) across it, ``launches``, that of the CUDA launches
    of the three kernel wrappers, and ``products``, that of the H-matrix
    products (``matvec.products``).

    ``device`` (a tensor or a ``torch.device``): the device that does the
    span's work.  On a CUDA device two CUDA events on its current stream
    give the record's ``device_us`` when :func:`spans` reads it; on the CPU
    ``device_us`` is the span's own duration.  ``sync`` (a tensor or a
    ``torch.device``): on, the span ends when that device has finished its
    queued work.  While the current stream captures a CUDA graph the span is
    off, profiler or not."""
    if not _profiler_on() or _capturing():
        return _OFF
    return _Span(name, sync, device)


def annotate(name: str):
    """Named region for device traces: a :func:`span`."""
    return span(name)


def spans() -> list:
    """The finished span records, in order of start, as dicts (see
    :func:`span`); ``device_us`` resolved from their CUDA events, after one
    synchronization."""
    done = [r for r in _records if r["t1"] is not None]
    timed = [r for r in done if "_events" in r]
    if timed:
        torch.cuda.synchronize()
        for r in timed:
            start, end = r.pop("_events")
            r["device_us"] = start.elapsed_time(end) * 1e3
    return [dict(r) for r in done]


def clear() -> None:
    """Forget every finished record and the count of dropped ones."""
    global _dropped
    _records[:] = [r for r in _records if r["t1"] is None]
    _dropped = 0


def dropped() -> int:
    """Spans not recorded since the last :func:`clear`: the buffer held
    ``MAX_SPANS``."""
    return _dropped


def self_times(records: list, name: str, less=()) -> list:
    """Of each record named ``name``, its duration less those of its direct
    children named in ``less``, in ns."""
    spent: dict = {}
    for r in records:
        if r["name"] in less and r["parent"] is not None:
            spent[r["parent"]] = spent.get(r["parent"], 0) + r["t1"] - r["t0"]
    return [r["t1"] - r["t0"] - spent.get(r["id"], 0) for r in records if r["name"] == name]


class Timer:
    """Accumulating wall-clock phase timer writing into an info dict —
    the ``std::chrono``/``MPI_Wtime`` pattern of the reference::

        t = Timer(infos)
        with t.phase("assembly", sync=H_data):
            ...

    ``sync`` (a tensor or a ``torch.device``): the phase ends only when that
    device has finished its queued work, so the time covers the work and not
    only its launch."""

    def __init__(self, infos: dict):
        self.infos = infos

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            key = f"{name}_walltime"
            self.infos[key] = self.infos.get(key, 0.0) + time.perf_counter() - t0