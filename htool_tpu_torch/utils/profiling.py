"""Profiling hooks — wall-clock phase timers and device traces.

Port of ``htool_tpu/utils/profiling.py``.  The reference records wall-clock
phase timings in info maps (``tree_builder.hpp:308-316``,
``ddm.hpp:66-122``); this package does the same (``HMatrix.info``, solver
``infos``, the GenEO infos) and adds a device trace through
``torch.profiler`` (CPU and CUDA activities, a Chrome trace).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["device_trace", "Timer", "annotate"]


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
    code while tracing.  Yields the ``torch.profiler.profile`` object
    (``key_averages()`` and the like)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, with_stack=host_profile) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region for device traces (``torch.profiler.record_function``)."""
    return record_function(name)


def _synchronize(sync) -> None:
    device = sync if isinstance(sync, torch.device) else getattr(sync, "device", None)
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


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
