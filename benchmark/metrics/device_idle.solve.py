"""The device's idle share over the traced stretch of solves after the window,
%: 1 − busy/wall, busy the union of the trace's kernel, memcpy and memset
intervals."""


def read(rec):
    t = rec.trace
    if rec.kind != "solve_stream" or t is None or not t["device_events"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
