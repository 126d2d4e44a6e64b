"""What a run records for the metric readers: its units, spans, counters
and the summary of the traced stretch."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


class Spans:
    """Host-clock spans around the harness's calls into each layer.  A span
    with ``sync`` ends when the device has finished the work it queued.
    Spans add into the dict ``current`` (one per unit); with ``annotate``
    they also show in a profiler trace as ``bench.<name>``."""

    def __init__(self):
        self.current: Optional[dict] = None
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str, sync: Optional[Callable[[], None]] = None):
        if self.annotate:
            from torch.profiler import record_function

            cm = record_function(f"bench.{name}")
        else:
            cm = contextlib.nullcontext()
        t0 = time.perf_counter()
        with cm:
            yield
            if sync is not None:
                sync()
        if self.current is not None:
            self.current[name] = self.current.get(name, 0.0) + time.perf_counter() - t0


@dataclass
class Record:
    """One run, as the readers see it.

    ``units``: one dict a solve (``solve_stream``) or problem
    (``new_problem``) of the window: ``seconds``, ``iterations``,
    ``converged`` and ``spans`` (name -> seconds).  ``trace``: the profiled
    stretch after the window (``busy_s``, ``window_s``, ``device_events``),
    or None.  ``counters``: numbers the harness counted, such as one
    product's bytes and its time over a batch (``product_bytes``,
    ``product_seconds``)."""

    kind: str
    device_kind: str
    setup_s: float = 0.0
    window_s: float = 0.0
    units: list = field(default_factory=list)
    peak_bytes: Optional[int] = None
    trace: Optional[dict] = None
    counters: dict = field(default_factory=dict)

    def span_mean_s(self, name: str) -> Optional[float]:
        vals = [u["spans"][name] for u in self.units if name in u["spans"]]
        return sum(vals) / len(vals) if vals else None
