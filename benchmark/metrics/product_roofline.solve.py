"""The product's share of its memory roofline, %: the bytes one ``H @ x`` at
the cell's k must move (``harness.roofline.product_bytes``) over the
device's HBM bandwidth, divided by one product's time from CUDA events
around a batch of products."""

from harness.roofline import peak_bandwidth


def read(rec):
    c = rec.counters
    peak = peak_bandwidth(rec.device_kind)
    if rec.kind != "solve_stream" or "product_seconds" not in c or peak is None:
        return None
    return 100.0 * c["product_bytes"] / peak / c["product_seconds"]
