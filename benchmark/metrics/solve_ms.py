"""Mean time of a solve, ms: the whole window over the solves completed in it."""


def read(rec):
    if rec.kind != "solve_stream" or not rec.units:
        return None
    return 1e3 * rec.window_s / len(rec.units)
