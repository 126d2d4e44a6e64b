"""``torch_bench.py``'s solver and factorization rows on the CPU.

``ddm_n100000``, ``ddm2_n20000``, ``blr2_n10000`` and ``blr_n10000`` with
``--device cpu --n 1500`` in one subprocess with a timeout (the product
rows are ``tests/test_torch_bench.py``'s: every row process imports torch
anew, which on the CPU takes seconds, so the rows are shared between the
two files).  Each row must exit clean with ``bench.py``'s metric keys and
``accuracy_ok``/``converged``; at this n the Schwarz rows take fewer
subdomains, and the two-level BLR row smaller panels, than their own n."""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_bench import check_row, run_bench  # noqa: E402

ROWS = ["ddm_n100000", "ddm2_n20000", "blr2_n10000", "blr_n10000"]


@pytest.fixture(scope="module")
def solver_rows(tmp_path_factory):
    return run_bench(tmp_path_factory.mktemp("bench"), ROWS, 1500)


@pytest.mark.parametrize("name", ROWS)
def test_row_is_clean(solver_rows, name):
    check_row(solver_rows[1], name, 1500)


def test_run_exits_clean(solver_rows):
    run, aux = solver_rows
    assert run.returncode == 0, run.stderr[-3000:]
    assert aux["violations"] == [] and aux["skipped"] == {} and aux["rows"] == ROWS
    assert aux["ddm_n100000"]["subdomains"] == aux["ddm2_n20000"]["subdomains"] == 8
    assert aux["blr2_n10000"]["n_panels"] == 4
    assert set(aux["iterations"]) == {"ras_gmres_1level", "ras_gmres_1level_20k",
                                      "ras_geneo_additive_2level_20k"}
