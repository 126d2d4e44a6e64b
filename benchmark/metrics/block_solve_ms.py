"""Mean time of a block solve, ms: the whole window over the solves completed
in it, as ``solve_ms`` reads it, in the cells whose solves serve a block of
right-hand sides (their own bound: block GMRES's host-paced steps spread more
from run to run than a CG solve does)."""

from pathlib import Path

from harness.spec import _load_module

read = _load_module(Path(__file__).with_name("solve_ms.py"), "bench_metric").read
