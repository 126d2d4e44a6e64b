"""The program's own spans and counters, for the per-layer readers that
read them.

``htool_tpu_torch.utils.profiling`` records its ``htool.*`` spans only
while a torch profiler records: in a run, over the traced stretch after the
window (``devtrace.profile``: 25 solves or 2 problems) and nowhere else.
Where the program has no recorder (a checkout before it), or the run traced
nothing, there is nothing to read and the readers return None.
"""

from __future__ import annotations


def records():
    """The recorder's finished span records (dicts: ``name``, ``id``,
    ``parent``, ``root``, ``t0``/``t1`` in ns, ``device_us`` where timed on
    the device, ``counters`` on a root span), or None."""
    try:
        from htool_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return (read() or None) if read is not None else None


def named(recs, name: str) -> list:
    return [r for r in recs or () if r["name"] == name]


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def mean_ms(recs, name: str):
    """Mean duration of the spans ``name``, ms."""
    m = mean(r["t1"] - r["t0"] for r in named(recs, name))
    return None if m is None else m / 1e6
