"""A cell on several cards: one process a card, each a rank of one process
group, every rank running the whole cell (SPMD).

``run.py`` is the parent of a cell whose ``chips`` W is more than 1.  It
builds what every rank loads once (``prebuild``: the CUDA kernels and the
native planner; W ranks building into one directory at once would race),
starts W copies of itself with the same arguments (``launch``), waits for
them (``wait``: the first rank that fails, or the time limit, ends every
rank) and, once every rank has exited 0, passes on the tail of rank 0's
standard error and then its standard output, whose last line is the result
(``parent``).  A rank that failed leaves no result: the parent prints the
tail of each failed rank's standard error and exits nonzero.

A rank is told so by the launch (``LAUNCH``, set by ``launch`` alone:
the file store's address and the parent's start time), beside ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` as a launcher sets
them.  ``run_rank`` starts the process group with the port's
``initialize_multihost`` (NCCL between cards, one rank a card by
``rank_device``; gloo on the CPU) before the program is built, and hands the
runner a ``Ranks``: rank 0 owns the clock and broadcasts the end of the
window, every rank runs the product probe and the traced stretch (they call
collectives) while rank 0 alone records the profile, the peaks are
gathered, and the comparison runs on rank 0 once every rank has released its
problem.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from . import devtrace, imports, runner

# the launch's hand-off to its ranks: {"store": init method, "t_start": s}
LAUNCH = "HTOOL_BENCH_LAUNCH"
# seconds a multi-card run may take beyond its window: set-up, warm-up, the
# traced stretch and the comparison; the kernels are built before it starts
SETUP_ALLOWANCE_S = 270.0
# bytes of rank 0's standard error passed on
TAIL = 64 * 1024


def time_limit(seconds: float) -> float:
    """The ranks' time limit for a window of ``seconds``."""
    return float(seconds) + SETUP_ALLOWANCE_S


# ----------------------------------------------------------------------
# the parent
# ----------------------------------------------------------------------


def prebuild(device_type: str) -> None:
    """Build what every rank loads, once, before any rank starts: the native
    planner, and on cards the CUDA kernel library (built, not loaded: the
    parent takes no card)."""
    from htool_tpu_torch import native

    native.native_available()
    if device_type == "cuda":
        from htool_tpu_torch.kernels import build_library

        build_library()


def launch(cmd: list, world: int, t_start: float, workdir: str) -> list:
    """Start ``cmd`` as ranks 0 .. world − 1, each with its standard output
    and error in ``workdir`` (``rank<r>.out``, ``rank<r>.err``), sharing a
    file store there.  Returns the processes."""
    hand = json.dumps({"store": "file://" + os.path.join(workdir, "store"), "t_start": t_start})
    threads = str(max(1, (os.cpu_count() or 1) // world))
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), **{LAUNCH: hand})
        # the ranks share this host: their transports connect over loopback,
        # and its cores are shared out as one card's process has them
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        env.setdefault("OMP_NUM_THREADS", threads)
        with open(os.path.join(workdir, f"rank{r}.out"), "w") as out, \
                open(os.path.join(workdir, f"rank{r}.err"), "w") as err:
            procs.append(subprocess.Popen(cmd, env=env, stdout=out, stderr=err,
                                          stdin=subprocess.DEVNULL))
    return procs


def wait(procs: list, timeout: float) -> dict:
    """Wait for every rank; the first that fails, or the time limit, ends
    them all (a rank whose peer is gone waits in a collective for ever).
    Returns {rank: reason} of the ranks that did not succeed; no process is
    left running."""
    deadline = time.monotonic() + timeout
    failed = {}
    try:
        while any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                if p.poll() not in (None, 0) and r not in failed:
                    failed[r] = f"exit code {p.returncode}"
            overran = time.monotonic() > deadline
            if failed or overran:
                for r, p in enumerate(procs):
                    if p.poll() is None:
                        failed[r] = (f"overran the time limit of {timeout:g} s" if overran
                                     else "killed: another rank failed")
                        p.kill()
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0 and r not in failed:
            failed[r] = f"exit code {p.returncode}"
    return failed


def _tail(path: str, size: int = TAIL) -> str:
    with open(path, "rb") as f:
        f.seek(max(0, os.path.getsize(path) - size))
        return f.read().decode(errors="replace")


def parent(cmd: list, world: int, timeout: float, t_start: float, device_type: str,
           workdir=None, out=None, err=None) -> int:
    """Run ``cmd`` as ``world`` ranks and pass on rank 0's output; the exit
    code: 0, or 6 where a rank failed or overran ``timeout``.  ``workdir``
    (kept) holds the store and the ranks' output; by default a temporary
    directory, removed."""
    out = out or sys.stdout
    err = err or sys.stderr
    prebuild(device_type)
    keep = workdir is not None
    workdir = workdir or tempfile.mkdtemp(prefix="bench_ranks_")
    try:
        t0 = time.perf_counter()
        failed = wait(launch(cmd, world, t_start, workdir), timeout)
        if failed:
            for r in sorted(failed):
                tail = _tail(os.path.join(workdir, f"rank{r}.err"), 8000)
                print(f"rank {r}: {failed[r]}\n{tail}", file=err)
            err.flush()
            return 6
        print(f"ranks: {world} exited 0 in {time.perf_counter() - t0:.3f}s", file=err)
        err.write(_tail(os.path.join(workdir, "rank0.err")))
        err.flush()
        with open(os.path.join(workdir, "rank0.out")) as f:
            out.write(f.read())
        out.flush()
        return 0
    finally:
        if not keep:
            shutil.rmtree(workdir, ignore_errors=True)


# ----------------------------------------------------------------------
# a rank
# ----------------------------------------------------------------------


def in_rank() -> bool:
    """Whether this process is a rank that ``launch`` started."""
    return LAUNCH in os.environ


class Ranks:
    """This rank's part in the runner's few collectives, on the world group:
    tensors on this rank's card under NCCL, on the CPU under gloo."""

    def __init__(self, rank: int, world: int, device: torch.device):
        self.rank, self.world = rank, world
        self.device = device if dist.get_backend() == "nccl" else torch.device("cpu")
        self._flag = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.flags, self.flag_s = 0, 0.0

    def window_ends(self, done: bool) -> bool:
        """Rank 0's ``done``, on every rank: one broadcast after each unit."""
        t0 = time.perf_counter()
        self._flag.fill_(int(done))
        dist.broadcast(self._flag, src=0)
        ends = bool(self._flag.item())
        self.flags += 1
        self.flag_s += time.perf_counter() - t0
        return ends

    def gather(self, value) -> list:
        """Every rank's ``value`` (a whole number or None), in rank order."""
        mine = torch.tensor([-1 if value is None else int(value)], dtype=torch.int64,
                            device=self.device)
        every = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(every, mine)
        return [None if v < 0 else v for v in (int(t.item()) for t in every)]

    def largest(self, peak):
        """The largest of the ranks' peaks (None where no rank has one);
        rank 0 writes each rank's to standard error."""
        peaks = self.gather(peak)
        if self.rank == 0:
            print(f"peak_bytes by rank {peaks}", file=sys.stderr)
        known = [p for p in peaks if p is not None]
        return max(known) if known else None

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def profile(self, fn, sync):
        """The traced stretch: rank 0 records it (``devtrace.profile``), the
        other ranks run it unrecorded, since it calls collectives."""
        if self.rank == 0:
            return devtrace.profile(fn, sync)
        fn()
        sync()
        return None


def join(device_type: str) -> tuple:
    """Start this rank's process group (``initialize_multihost``: NCCL and
    this rank's card for ``"cuda"``, gloo for ``"cpu"``); returns (its
    ``Ranks``, its device, the parent's start time)."""
    from htool_tpu_torch.parallel import initialize_multihost

    hand = json.loads(os.environ[LAUNCH])
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    initialize_multihost(hand["store"], world, rank, device=device_type)
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    return Ranks(rank, world, device), device, float(hand["t_start"])


def run_rank(spec, cell_name: str, seed: int, seconds: float, trace: bool,
             device_type: str):
    """This rank's run of the cell: the result on rank 0, None on the
    others.  Raises ``runner.ForbiddenImport`` on any rank where JAX or the
    JAX package is loaded once the window has closed."""
    from htool_tpu_torch.parallel import shutdown_multihost

    ranks, device, t_start = join(device_type)
    result = runner.run(spec, cell_name, seed, seconds, trace, device, t_start, ranks=ranks)
    if ranks.rank:
        found = imports.forbidden()
        if found:
            raise runner.ForbiddenImport(f"rank {ranks.rank}: loaded after the window: "
                                         f"{', '.join(found)}")
    else:
        print(f"window flag: {ranks.flags} broadcasts, mean "
              f"{1e6 * ranks.flag_s / max(1, ranks.flags):.1f} us", file=sys.stderr)
    shutdown_multihost()  # the other ranks wait here while rank 0 compares
    return result
