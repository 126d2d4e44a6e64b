"""The port's profiling hooks on the CPU: Timer's info entries, annotate's
named regions and device_trace's Chrome trace, with and without the host's
Python calls (``host_profile``)."""

import json
import time

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from htool_tpu.utils.profiling import Timer as JaxTimer
from htool_tpu_torch.utils import Timer, annotate, device_trace


def test_timer_accumulates_like_the_reference():
    infos_t, infos_j = {}, {}
    for infos, timer in ((infos_t, Timer(infos_t)), (infos_j, JaxTimer(infos_j))):
        for _ in range(2):
            with timer.phase("assembly"):
                time.sleep(0.01)
        with timer.phase("solve"):
            pass
    assert set(infos_t) == set(infos_j) == {"assembly_walltime", "solve_walltime"}
    assert infos_t["assembly_walltime"] >= 0.02


def test_timer_sync_and_exceptions():
    infos = {}
    x = torch.ones(4)
    with Timer(infos).phase("cpu", sync=x):
        x.add_(1)
    with Timer(infos).phase("device", sync=torch.device("cpu")):
        pass
    with pytest.raises(KeyError):
        with Timer(infos).phase("failed"):
            raise KeyError("x")
    assert set(infos) == {"cpu_walltime", "device_walltime", "failed_walltime"}


def test_device_trace_and_annotate(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        with annotate("htool_product"):
            torch.ones(64, 64) @ torch.ones(64, 8)
    names = {e.key for e in prof.key_averages()}
    assert "htool_product" in names
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "htool_product" for e in events)


def _traced_helper():
    return torch.ones(32, 32) @ torch.ones(32, 4)


@pytest.mark.parametrize("host_profile", [False, True])
def test_device_trace_host_profile(tmp_path, host_profile):
    """``host_profile=True`` (the JAX package's ``device_trace`` flag) also
    records the host's Python calls, as ``python_function`` events in the
    trace; without it there are none."""
    with device_trace(str(tmp_path / "trace"), host_profile=host_profile) as prof:
        _traced_helper()
    calls = [e.name for e in prof.events() if "_traced_helper" in e.name]
    assert bool(calls) == host_profile, calls
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    python = [e for e in events if e.get("cat") == "python_function"]
    assert bool(python) == host_profile
    assert any("_traced_helper" in e["name"] for e in python) == host_profile
