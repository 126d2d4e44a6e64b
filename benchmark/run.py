"""The benchmark of htool_tpu_torch: one run of one cell on its GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``); the last lines of
standard error are the numbers compared, each beside its limit.  The run
fails, and prints no result, without a CUDA device, without the port in the
checkout, or where JAX or the JAX package is loaded.  A cell on W > 1
cards runs as W processes, one rank a card (``harness/ranks.py``).  See
README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the port's compiled kernels: one fixed directory in the checkout, so only
# the first run of a checkout compiles
BUILD = os.path.join(HERE, "_build")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)

    os.environ["HTOOL_TPU_TORCH_KERNEL_DIR"] = os.path.join(BUILD, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
    sys.path[:0] = [HERE, ROOT]

    from harness import runner
    from harness.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload}: needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import htool_tpu_torch
    except ImportError as e:
        print(f"the port htool_tpu_torch is not in this checkout: {e}", file=sys.stderr)
        return 4
    if not os.path.abspath(htool_tpu_torch.__file__).startswith(os.path.join(ROOT, "")):
        print(f"htool_tpu_torch was imported from {htool_tpu_torch.__file__}, "
              f"not from the checkout {ROOT}", file=sys.stderr)
        return 4

    chips = int(cell["chips"])
    if chips > 1:
        from harness import ranks

        if not ranks.in_rank():
            return ranks.parent([sys.executable, os.path.abspath(__file__), *argv], chips,
                                ranks.time_limit(args.seconds), T_START, "cuda")
    try:
        if chips > 1:
            result = ranks.run_rank(spec, args.workload, args.seed, args.seconds,
                                    bool(args.trace), "cuda")
        else:
            result = runner.run(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                                torch.device("cuda", 0), T_START)
    except runner.ForbiddenImport as e:
        print(f"{args.workload}: {e}", file=sys.stderr)
        return 5
    if result is not None:
        runner.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
