"""Host time of build_cluster_tree (the native planner) a problem, ms.
Mean of the span ``tree`` over the window's problems."""


def read(rec):
    if rec.kind != "new_problem":
        return None
    s = rec.span_mean_s("tree")
    return None if s is None else 1e3 * s
