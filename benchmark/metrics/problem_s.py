"""Mean time of a whole problem, s: the whole window over the problems
completed in it."""


def read(rec):
    if rec.kind != "new_problem" or not rec.units:
        return None
    return rec.window_s / len(rec.units)
