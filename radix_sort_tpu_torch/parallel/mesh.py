"""The mesh: a process group, this process's rank in it and its device.

Port of ``radix_sort_tpu/parallel/mesh.py``.  The JAX mesh is one program
over a 1-D array of devices; here every rank is a process of its own
(``torch.distributed``), and the distributed operators take a
:class:`Mesh` as the JAX ones take a ``jax.sharding.Mesh``.

Backends:

- ``nccl``: ranks on separate cards (``cuda:<rank>``), and the world of one
  rank on the card that :func:`make_mesh` makes when no group is running;
- ``gloo``: CPU ranks (the tests), and several ranks that share one card,
  each rank's tensors on ``cuda:0``.  A gloo collective goes through host
  memory: gloo copies a CUDA tensor to the host, moves it, and copies it
  back.  Choosing gloo chooses that transport; asking for NCCL never gives
  gloo.

:func:`run_ranks` starts the ranks of one machine as processes of
``torch.multiprocessing`` (spawn) with a ``file://`` rendezvous in a
temporary directory, and returns each rank's result: the counterpart of a
JAX mesh over the local devices.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .. import dtypes

@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-D mesh: ``size`` ranks of ``group`` (None is
    the default group), this one ``rank``, its tensors on ``device``."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None


def _default_device(backend: str, rank: int) -> torch.device:
    """Card ``rank`` on NCCL; on gloo the card every rank shares (cuda:0).
    Raises where the process sees no card: a CPU mesh is asked for by
    name (``device="cpu"``), never chosen for a caller."""
    if not torch.cuda.is_available():
        raise ValueError(f"no CUDA card is visible to rank {rank} of the "
                         f"{backend} group: pass device='cpu' for a CPU "
                         f"mesh")
    if backend == "nccl":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cuda", 0)


def _check_device(dev: torch.device, backend: str) -> None:
    """NCCL moves CUDA tensors only: a NCCL mesh on another device raises
    here, before a collective does."""
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"a mesh on {dev} cannot use the NCCL group (NCCL "
                         f"moves CUDA tensors only): move the tensors to the "
                         f"card, or run the ranks over gloo")


def make_mesh(num_devices: int | None = None, *, backend: str | None = None,
              device=None) -> Mesh:
    """The mesh of the running process group.  With no group running, a
    world of one rank: on ``device`` (the card unless the caller asks for
    the CPU), over NCCL on a card and gloo on the CPU.  ``num_devices`` and
    ``backend``, where given, must match the group, and a NCCL group takes
    CUDA devices only; a mismatch raises ValueError.  In a running group
    the mesh is on ``device``, else on card ``rank`` (NCCL) or on cuda:0
    (gloo); with no device named and no card visible it raises
    ValueError.  A group started here stays the process's default group,
    so a later call on another device must suit its backend."""
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {num_devices} ranks needs a running process "
                f"group: start the ranks with run_ranks, or under torchrun "
                f"with runtime.initialize")
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        want = backend or ("nccl" if dev.type == "cuda" else "gloo")
        _check_device(dev, want)
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
        return Mesh(0, 1, dev, want)
    size, rank = dist.get_world_size(), dist.get_rank()
    got = dist.get_backend()
    if backend is not None and backend != got:
        raise ValueError(f"asked for backend {backend!r}, the running group "
                         f"is {got!r}")
    if num_devices not in (None, size):
        raise ValueError(f"requested {num_devices} ranks, the group has "
                         f"{size}")
    dev = _default_device(got, rank) if device is None else torch.device(
        device)
    _check_device(dev, got)
    return Mesh(rank, size, dev, got)


def _ceil_split(n: int, mesh: Mesh):
    per = -(-n // mesh.size)
    lo = min(n, mesh.rank * per)
    return lo, min(n, lo + per)


def shard_1d(x, mesh: Mesh):
    """This rank's contiguous slice of a global 1-D array (numpy or torch)
    on the mesh's device: rows [r * per, (r + 1) * per) with per =
    ceil(n / D), the shards of the JAX ``NamedSharding(mesh, P(axis))``
    and of the JAX ``dist_sort`` layout."""
    lo, hi = _ceil_split(x.shape[0], mesh)
    if isinstance(x, np.ndarray):
        return dtypes.tensor_from_numpy(x[lo:hi], mesh.device)
    return x[lo:hi].to(mesh.device)


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's ``x`` on every rank (a broadcast; every rank passes a
    tensor of the same shape and dtype)."""
    t = dtypes.as_container(x.to(mesh.device)).contiguous().clone()
    dist.broadcast(t, dist.get_global_rank(mesh.group, 0)
                   if mesh.group is not None else 0, group=mesh.group)
    return dtypes.from_container(t, x.dtype)


def device_banner(mesh: Mesh | None = None) -> str:
    """Platform and device line, as the JAX banner (the reference's
    ComputeState banner)."""
    lines = [f"torch {torch.__version__} cuda {torch.version.cuda}"]
    if mesh is not None:
        lines[0] += f" backend={mesh.backend} ranks={mesh.size}"
        dev = mesh.device
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        lines.append(f"  rank {mesh.rank}: {dev} {name}")
    else:
        for i in range(torch.cuda.device_count()):
            lines.append(f"  device {i}: {torch.cuda.get_device_name(i)} "
                         f"(cuda)")
    return "\n".join(lines)


# ------------------------------------------------------------ collectives
#
# Every collective of the layer goes through these four, so each rank's
# counts, samples and rows take one path per backend.

def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(D, *t.shape): every rank's ``t`` in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.stack(parts)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's ``t`` (a new tensor)."""
    t = t.contiguous().clone()
    dist.all_reduce(t, group=mesh.group)
    return t


def all_to_all_rows(out: torch.Tensor, block: torch.Tensor, out_splits,
                    in_splits, mesh: Mesh, async_op: bool = False):
    """Rows ``block[sum(in_splits[:d]) : ...]`` go to rank d; rank s's rows
    land in ``out`` at ``sum(out_splits[:s])``.  Returns the work handle
    when ``async_op``."""
    return dist.all_to_all_single(out, block, list(out_splits),
                                  list(in_splits), group=mesh.group,
                                  async_op=async_op)


# --------------------------------------------------------------- launcher

def _rank_main(fn, rank, world_size, backend, device, init, args, results,
               threads, timeout_s):
    """One rank: join the group, run ``fn(mesh, *args)``, send back
    (rank, ok, result or traceback)."""
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(Mesh(rank, world_size, dev, backend), *args)
        finally:
            dist.destroy_process_group()
        # pickled here, so a result that cannot be sent fails this rank
        results.put((rank, True, pickle.dumps(out)))
    except Exception:  # noqa: BLE001 - the parent raises it with the trace
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world_size: int, *, backend: str, device, args=(),
              timeout_s: float = 600.0, threads: int | None = None):
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks, one spawned process
    each, and return their results in rank order.

    ``fn`` and its results are pickled, so ``fn`` is a module-level
    function of a module that the ranks can import.  ``backend`` is "nccl"
    (a card a rank) or "gloo"; ``device`` is where each rank's tensors
    live: "cuda" for card ``rank``, one card for every rank ("cuda:0",
    with gloo), or "cpu" (gloo).  The ranks meet through a file
    in a fresh temporary directory, so runs never share a port.  A rank
    that raises makes this raise with its traceback; ranks still running
    after ``timeout_s`` are killed."""
    _check_device(torch.device(device), backend)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="rst_ranks_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, backend, str(device), init,
                               tuple(args), results, threads, timeout_s))
             for r in range(world_size)]
    got = {}
    try:
        for p in procs:
            p.start()
        for _ in range(world_size):
            try:
                rank, ok, out = results.get(timeout=timeout_s)
            except queue_mod.Empty:
                late = sorted(set(range(world_size)) - set(got))
                raise RuntimeError(f"run_ranks: no result within {timeout_s} "
                                   f"s from ranks {late}")
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{out}")
            got[rank] = pickle.loads(out)  # bytes our own rank wrote
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world_size)]
