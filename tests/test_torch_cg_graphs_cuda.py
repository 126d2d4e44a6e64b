"""CG's step replayed from CUDA graphs against the eager loop, on the card:
``chip_smoke.cg_graphs_check`` (equal iterations in float32 and float64, x
within 1e-5 and 1e-10 relative, equal CUDA launches and syncs a solve, one
replayed step an iteration, an answer left as it was by the next solve) on
a sphere of 8,000 points, with one-level ASM and without a
preconditioner (no apply segment to replay).  CUDA graphs exist only on a CUDA device: without
one the tests skip.  Run on the card with

    python -m pytest tests/test_torch_cg_graphs_cuda.py -q
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CG's graphs are captured only on the card")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("dtype, schwarz", [("float32", "asm"), ("float64", "asm"),
                                            ("float32", "none")])
def test_graph_solve_against_eager_on_the_card(card, dtype, schwarz):
    out = card.cg_graphs_check(8000, getattr(torch, dtype), reps=3, schwarz=schwarz)
    assert out["iterations_graph"] == out["iterations_eager"] > 0
    assert out["graph_solve"]["steps"] == out["iterations_graph"]
