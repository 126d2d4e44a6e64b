"""Device time from a profiler trace, and product time from CUDA events.

``summarize`` is the arithmetic of ``chip_smoke.py``'s ``profile_window``:
the device is busy over the union of the trace's kernel, memcpy and memset
intervals, and idle for the rest of the traced window.  It adds the
breakdown: device time by operation, and each idle gap named by what the
host was doing at its middle (the harness's span ``bench.<name>`` and the
outermost host operator running then).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "bench.stretch"
TOP = 10


def _merge(intervals):
    """The union of [a, b) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Outermost:
    """The events that no other event of the list contains, for a lookup by
    time (host operators and spans of one thread nest, they do not cross)."""

    def __init__(self, events):
        self.events, end = [], float("-inf")
        for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
            if e["ts"] >= end:
                self.events.append(e)
                end = e["ts"] + e["dur"]
        self.starts = [e["ts"] for e in self.events]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.events[i]["ts"] + self.events[i]["dur"]:
            return self.events[i]["name"]
        return None


def summarize(events: list, wall_s: float) -> dict:
    """From Chrome-trace events (``ts``, ``dur`` in µs) of one traced
    stretch: ``busy_s``, ``window_s`` (= ``wall_s``, the host's time for the
    stretch), ``device_events``, and the breakdown's ``device_ops`` and
    ``idle_gaps`` ([name, seconds], the largest first, at most 10 each)."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in complete if e.get("cat") in DEVICE_CATS]
    spans = [e for e in complete if e.get("cat") == "user_annotation"]
    ops = [e for e in complete if e.get("cat") == "cpu_op"]
    stretch = [e for e in spans if e["name"] == STRETCH]
    lo = min((e["ts"] for e in stretch), default=min((e["ts"] for e in complete), default=0.0))
    hi = max((e["ts"] + e["dur"] for e in stretch),
             default=max((e["ts"] + e["dur"] for e in complete), default=0.0))
    busy = _merge((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in dev
                  if e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy_us = sum(b - a for a, b in busy)

    by_op: dict = {}
    for e in dev:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + e["dur"] / 1e6
    tids = {e.get("tid") for e in stretch}
    inner = _Outermost(e for e in spans if e["name"] != STRETCH)
    host = _Outermost(e for e in ops if not tids or e.get("tid") in tids)
    gaps: dict = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = f"{inner.at(mid) or 'harness'}/{host.at(mid) or 'python'}"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6

    def top(d):
        return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return dict(busy_s=busy_us / 1e6, window_s=wall_s, device_events=len(dev),
                device_ops=top(by_op), idle_gaps=top(gaps))


def profile(fn, sync) -> dict:
    """Run ``fn`` under ``torch.profiler`` (CPU and, where there is one, CUDA
    activities) and summarize its trace.  The trace is written to a
    temporary file, read and deleted."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(STRETCH):
            fn()
            sync()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events, wall)


def time_batch(fn, reps: int, device) -> float:
    """Seconds a call of ``fn`` over ``reps`` calls in a row, after two
    warm calls: from CUDA events on a GPU, from the host clock elsewhere."""
    import torch

    for _ in range(2):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps
