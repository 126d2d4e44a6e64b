"""The 95th percentile of every solve's time in the window, ms (host clock
from the call to the synchronized return)."""

import numpy as np


def read(rec):
    if rec.kind != "solve_stream" or not rec.units:
        return None
    return 1e3 * float(np.percentile([u["seconds"] for u in rec.units], 95))
