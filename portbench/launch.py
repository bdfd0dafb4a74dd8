"""A run of a cell on several cards: one process a card, in lockstep.

``launch`` starts ``cell.chips`` rank processes (``spawn``), each with the
environment a launcher such as ``torchrun`` exports (``MASTER_ADDR``
127.0.0.1, a free ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``).  A rank joins the program's process group as a user of
the port does, ``parallel.runtime.initialize(backend="nccl")``, then the
harness's own group, ``dist.new_group(backend="gloo")``: every
coordination of the harness (the flag before each call, the gathering of
latencies, peaks and traces, the check's sums) runs there, off the
program's NCCL streams.  Each rank then runs ``core.drive`` with a
:class:`Ranks`; rank 0 assembles the result line and hands it to the
launcher, which prints it once every rank has ended with code 0.

A rank that raises ends its process with a non-zero code; the launcher
then kills every other rank and returns that code, with no result.  Every
wait of the harness has a timeout (``WAIT_S`` on the gloo group,
``timeout_s`` over the whole run), so a run never hangs.
"""

from __future__ import annotations

import datetime
import json
import os
import queue as queue_mod
import socket
import sys
import time
import traceback

import torch
import torch.distributed as dist

from portbench import trace as trace_lib

WAIT_S = 300.0  # the longest wait of one harness collective
POLL_S = 0.2


class Ranks:
    """The harness's view of the mesh: this process's ``rank`` of ``size``
    and the harness's gloo ``group``.  Every rank calls each method in the
    same order."""

    def __init__(self, rank: int, size: int, group):
        self.rank, self.size, self.group = rank, size, group

    def flag(self, value: int) -> int:
        """Rank 0's ``value`` (an int), on every rank."""
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.broadcast(t, 0, group=self.group)
        return int(t[0])

    def gather(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order, on every rank."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of a CPU tensor, in its own dtype."""
        t = t.contiguous().clone()
        dist.all_reduce(t, group=self.group)
        return t


def rank_table(res, allocator: list) -> dict:
    """Each rank's peak and allocator counts, every call's latency and,
    from a traced run, each rank's device-busy, work (outside NCCL), NCCL
    and idle ms a call in the profiled stretch: the table of the stderr
    line ``rank_breakdown``."""
    out = {"peak_bytes": res.rank_peak_bytes, "allocator": allocator,
           "latency_ms": [round(x, 3) for x in res.latencies_ms]}
    r = res.reading
    if r is not None and r.rank_traces:
        out["hot_rank"] = r.hot_rank
        out["busy_ms"] = [t.busy_us() / 1e3 / t.calls for t in r.rank_traces]
        out["work_ms"] = [t.work_us() / 1e3 / t.calls for t in r.rank_traces]
        out["nccl_ms"] = [trace_lib.per_call_ms(
            t, lambda n, k: trace_lib.is_collective(n))
            for t in r.rank_traces]
        out["idle_ms"] = [(t.span_us - t.busy_us()) / 1e3 / t.calls
                          for t in r.rank_traces]
    return out


def allocator_counts(dev) -> dict:
    """The caching allocator's counts over the run (warm-up, window and
    check): retries after a failed allocation, cudaMalloc and cudaFree
    calls, the peak reserved."""
    if dev.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(dev)
    return {k: st.get(k) for k in ("num_alloc_retries", "num_device_alloc",
                                   "num_device_free",
                                   "reserved_bytes.all.peak")}


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(cell, opts: dict, t_start: float, rank: int, port: int,
              device: str, backend: str, results, extra: dict,
              prelude=None) -> None:
    """One rank of a run (the target of each spawned process)."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(cell.chips), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    if prelude is not None:
        prelude[0](rank, *prelude[1:])
    from portbench import core, result
    from radix_sort_tpu_torch.parallel import runtime

    on_card = device == "cuda"
    # one intra-op thread a rank, as torchrun sets for several processes
    # a host: the ranks share the host's cores
    torch.set_num_threads(1)
    runtime.initialize(backend=backend)
    dev = torch.device("cuda", rank) if on_card else torch.device(device)
    group = dist.new_group(backend="gloo",
                           timeout=datetime.timedelta(seconds=WAIT_S))
    ranks = Ranks(rank, cell.chips, group)
    res = core.drive(cell, opts["seed"], opts["seconds"], opts["trace"], dev,
                     t_start, opts["program"], ranks=ranks)
    alloc = ranks.gather(allocator_counts(dev))
    bad = result.forbidden_modules()
    if bad:
        print(f"rank {rank}: loaded, and must not be: {', '.join(bad)}",
              file=sys.stderr, flush=True)
        sys.exit(4)
    if rank == 0:
        line = result.assemble(cell, res, res.ready_s, opts["trace"],
                               "gpu" if on_card else "cpu",
                               {**extra, "window_s": res.window_s})
        print("rank_breakdown " + json.dumps(rank_table(res, alloc)),
              file=sys.stderr, flush=True)
        results.put(line)
    ranks.gather(None)  # every rank is done with the harness's group
    dist.destroy_process_group()


def _rank_entry(*args) -> None:
    try:
        rank_main(*args)
    except Exception:  # noqa: BLE001 - the run fails; the trace says why
        print(f"rank {args[3]} failed:\n{traceback.format_exc()}",
              file=sys.stderr, flush=True)
        sys.exit(1)


def launch(cell, opts: dict, t_start: float, extra: dict, *,
           device: str = "cuda", backend: str = "nccl",
           timeout_s: float | None = None, prelude=None):
    """Run ``cell`` on ``cell.chips`` ranks.  ``opts``: seed, seconds,
    trace (bool), program.  Returns (exit code, rank 0's result line or
    None).  ``device`` "cpu" with ``backend`` "gloo" runs the ranks on the
    CPU (the tests); ``prelude`` (a module-level function and its
    arguments) runs first in each rank, as ``fn(rank, *args)``."""
    if timeout_s is None:
        timeout_s = 600.0 + 2 * opts["seconds"]
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(cell, opts, t_start, r, port, device, backend,
                               results, extra, prelude))
             for r in range(cell.chips)]
    deadline = time.time() + timeout_s
    line, rc = None, 0
    try:
        for p in procs:
            p.start()
        while True:
            try:
                line = results.get(timeout=POLL_S)
            except queue_mod.Empty:
                pass
            codes = [p.exitcode for p in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c not in (None, 0)]
            if failed:
                r, c = failed[0]
                print(f"rank {r} ended with code {c}: no result",
                      file=sys.stderr, flush=True)
                rc = c if c > 0 else 1
                break
            if all(c == 0 for c in codes):
                break
            if time.time() > deadline:
                print(f"no end within {timeout_s:.0f} s: no result",
                      file=sys.stderr, flush=True)
                rc = 124
                break
        if rc == 0 and line is None:
            try:
                line = results.get(timeout=WAIT_S)
            except queue_mod.Empty:
                print("rank 0 handed over no result", file=sys.stderr,
                      flush=True)
                rc = 1
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
    return rc, (line if rc == 0 else None)
