"""``product_roofline.solve``, read in a cell that reports ``block_solve_ms``: the same
reading, moving that cell's end-to-end metric."""

from pathlib import Path

from harness.spec import _load_module

read = _load_module(Path(__file__).with_name("product_roofline.solve.py"), "bench_metric").read
