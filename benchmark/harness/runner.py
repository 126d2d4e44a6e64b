"""One run of one cell: set up, warm up, the measured window, the traced
stretch, the comparison, the metrics, and the result line."""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import torch

from . import check, devtrace, imports, roofline
from .inputs import TRACE, WARMUP, WINDOW
from .record import Record, Spans


class ForbiddenImport(RuntimeError):
    pass


def _sync_of(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def power_limit_w(device: torch.device):
    """The card's power limit from ``nvidia-smi``, or None."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(spec, cell_name: str, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, side=None, units=None, ranks=None) -> dict:
    """The result line's object.  ``side``: the system under test, built
    from the cell's configuration and mix; the configuration's program
    (``programs/<program>.py``) unless ``calibrate.py`` puts the control in
    its place.  ``units``: run that many units in the window instead of
    ``seconds`` of them (``calibrate.py``'s readings).  ``ranks``: this
    rank's ``harness.ranks.Ranks`` in a cell on several cards, where every
    rank runs this and rank 0 alone returns the result (the others None).
    Raises ``ForbiddenImport`` where JAX or the JAX package is loaded once
    the window has closed."""
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    kernel = spec.kernel(cfg["kernel"])
    side = (side or spec.program(cfg["program"]))(cfg, kernel, device)
    sync = _sync_of(device)
    spans = Spans()
    loop = spec.kind(mix["kind"])(side, cfg, mix, seed, spans)
    rec = Record(kind=loop.kind, device_kind=device_kind(device))

    # set-up: the cell's own inputs and shapes, warmed by units outside the window's
    marks = [("start", t_start), ("imports", time.perf_counter())]
    loop.setup()
    marks.append(("cell_setup", time.perf_counter()))
    for i in range(int(mix["warmup_units"])):
        loop.unit(WARMUP, i)
    gc.collect()
    sync()
    if ranks is not None:
        ranks.barrier()
    marks.append(("warmup", time.perf_counter()))
    print("setup " + " ".join(f"{b[0]}={b[1] - a[1]:.3f}s" for a, b in zip(marks, marks[1:])),
          file=sys.stderr)

    t0 = time.perf_counter()
    rec.setup_s = t0 - t_start
    t_end = t0 + seconds
    while True:
        spans.current = {}
        u0 = time.perf_counter()
        unit = loop.unit(WINDOW, len(rec.units))
        sync()
        u1 = time.perf_counter()
        unit.update(seconds=u1 - u0, spans=spans.current)
        rec.units.append(unit)
        done = (len(rec.units) >= units) if units else (u1 >= t_end)
        if (done if ranks is None else ranks.window_ends(done)):
            break
    rec.window_s = u1 - t0
    spans.current = None
    secs = sorted(u["seconds"] for u in rec.units)
    print(f"window units={len(secs)} first={[round(u['seconds'], 4) for u in rec.units[:4]]} "
          f"median={secs[len(secs) // 2]:.4f}s max={secs[-1]:.4f}s iterations="
          f"{sorted({u['iterations'] for u in rec.units})}", file=sys.stderr)
    for i, u in enumerate(rec.units):
        if u["seconds"] > 2 * secs[len(secs) // 2] and u["seconds"] > 0.1:
            print(f"slow unit {i}: {u['seconds']:.4f}s "
                  + " ".join(f"{k}={v:.4f}" for k, v in u["spans"].items()), file=sys.stderr)
    if device.type == "cuda":
        rec.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if ranks is not None:
        rec.peak_bytes = ranks.largest(rec.peak_bytes)
    check_in = loop.collect()

    if trace:
        op = loop.probe()
        if op is not None:
            problem, X = op
            rec.counters["product_seconds"] = devtrace.time_batch(
                lambda: side.product(problem, X), int(mix["product_reps"]), device)
            rec.counters["product_bytes"] = roofline.product_bytes(side.operator(problem),
                                                                   X.shape[1])
            del problem, X
        spans.annotate = True
        rec.trace = (devtrace.profile if ranks is None else ranks.profile)(
            lambda: [loop.unit(TRACE, i) for i in range(int(mix["trace_units"]))], sync)
        spans.annotate = False
    power = power_limit_w(device)
    loop.release()
    del loop, side
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if ranks is not None:
        ranks.barrier()  # every rank has released its problem
        if ranks.rank:
            return None

    t_check = time.perf_counter()
    checks = check.compare(check_in, kernel, cfg["limits"], rec.units)
    del check_in
    print(f"reference check {time.perf_counter() - t_check:.3f}s", file=sys.stderr)

    metrics = {}
    for m in spec.metrics(cell_name, trace):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = imports.forbidden()
    if found:
        raise ForbiddenImport(f"loaded after the window: {', '.join(found)}")

    result = {
        "correct": check.passed(checks),
        "attempted": len(rec.units),
        "failed": checks["unconverged"]["value"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": rec.device_kind,
            "count": 1 if ranks is None else ranks.world,
            "memory_peak_bytes": rec.peak_bytes,
            "power_limit_w": power,
        },
    }
    if trace and rec.trace is not None:
        result["device"].update(busy_s=rec.trace["busy_s"], window_s=rec.trace["window_s"])
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    result["checks"] = checks
    return result


def emit(result: dict, out=None, err=None) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    out = out or sys.stdout
    err = err or sys.stderr
    err.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
