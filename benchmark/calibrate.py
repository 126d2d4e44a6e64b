"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... [--control-seeds 7,8,9]
                                   [--precisions tf32,tf32_offdiag,bf16_offdiag]
                                   [--units N] [--device cuda|cpu] [--out FILE]

For each seed, in one process, one run of the cell through the benchmark's
own runner (``harness.runner.run``): its set-up and warm-up, then N units of
its traffic (at least as many as a run samples for its check) in place of
the timed window, then the comparison; one JSON line a seed.
``--control-seeds`` runs the control in the program's place
(``reference/control.py``) in each of ``--precisions`` (default ``tf32``,
the precision below the configurations' float32 with TF32 off); a sound
comparison must call the ``tf32`` control wrong.  Needs a CUDA device
unless ``--device cpu``.  The benchmark's own runs never run this.
"""

import argparse
import functools
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def reading(spec, cell_name, seed, units, device, precision=None):
    """One seed's readings: the program's, or with ``precision`` the
    control's in that precision."""
    from harness import runner
    from reference.control import Control

    side = None if precision is None else functools.partial(Control, precision=precision)
    t0 = time.perf_counter()
    r = runner.run(spec, cell_name, seed, 0.0, False, device, t0, side=side, units=units)
    return dict(workload=cell_name, seed=seed, side=precision or "program", units=units,
                seconds=time.perf_counter() - t0, correct=r["correct"], metrics=r["metrics"],
                checks=r["checks"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--precisions", default="tf32")
    ap.add_argument("--units", type=int, default=0,
                    help="units a seed (default: the mix's check_units)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also append each line to this file")
    args = ap.parse_args(argv)
    os.environ["HTOOL_TPU_TORCH_KERNEL_DIR"] = os.path.join(HERE, "_build", "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "_build", "triton")
    sys.path[:0] = [HERE, ROOT]
    import torch

    from harness.spec import Spec

    spec = Spec(ROOT)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    units = args.units or int(spec.traffic(cell["traffic"])["check_units"])
    jobs = [(int(s), None) for s in args.seeds.split(",") if s]
    jobs += [(int(s), p) for p in args.precisions.split(",") if p
             for s in args.control_seeds.split(",") if s]
    for seed, precision in jobs:
        line = json.dumps(reading(spec, args.workload, seed, units, device, precision))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
