"""Krylov iterations a solve (``infos["Nb_it"]``), mean over the window."""


def read(rec):
    if rec.kind != "solve_stream" or not rec.units:
        return None
    return sum(u["iterations"] for u in rec.units) / len(rec.units)
