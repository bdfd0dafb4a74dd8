"""Multi-process runtime bootstrap and a health check.

Port of ``radix_sort_tpu/parallel/runtime.py``.  A launch of several
processes joins one process group before any collective runs; this wraps
``torch.distributed.init_process_group`` with the engine's conventions, and
adds the heartbeat that reports a dead or hung peer as a status instead of
a stalled collective.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

import torch
import torch.distributed as dist

from . import mesh as mesh_lib

# The environment ``torchrun`` exports to every process it starts: the
# counterpart of JAX_COORDINATOR_ADDRESS for jax.distributed.
_LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _env_launch() -> bool:
    return (all(os.environ.get(v) for v in _LAUNCH_ENV)
            and int(os.environ["WORLD_SIZE"]) > 1)


def _env_coordinator() -> str | None:
    if not _env_launch():
        return None
    return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"


@dataclasses.dataclass
class RuntimeInfo:
    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int
    coordinator: str | None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str = "nccl") -> RuntimeInfo:
    """Join (or, in a single process, skip) the process group.

    Several processes are meant when an argument is given or ``torchrun``'s
    environment names a world of more than one (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK).  The group joins over ``coordinator_address``
    ("host:port", TCP) or the environment, on ``backend``: NCCL, a card a
    process, unless the caller asks for "gloo" (CPU ranks, or ranks that
    share a card), as ``make_mesh(backend=...)``.  A NCCL group in a
    process that sees no card raises ValueError before it joins.  One rank
    a process: ``global_devices`` counts ranks.  Safe to call in a single
    process: it then starts nothing and describes the process."""
    multi = (coordinator_address is not None
             or num_processes not in (None, 1)
             or _env_launch())
    if multi and not dist.is_initialized():
        if backend == "nccl" and not torch.cuda.is_available():
            raise ValueError("a NCCL group needs a CUDA card and this "
                             "process sees none: pass backend='gloo' for "
                             "CPU ranks")
        init = ("env://" if coordinator_address is None
                else f"tcp://{coordinator_address}")
        kw = {}
        if num_processes is not None:
            kw["world_size"] = num_processes
        if process_id is not None:
            kw["rank"] = process_id
        dist.init_process_group(backend, init_method=init, **kw)
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            torch.cuda.set_device(local % torch.cuda.device_count())
    running = dist.is_initialized()
    return RuntimeInfo(
        process_id=dist.get_rank() if running else 0,
        num_processes=dist.get_world_size() if running else 1,
        local_devices=max(1, torch.cuda.device_count()),
        global_devices=dist.get_world_size() if running else 1,
        coordinator=coordinator_address or _env_coordinator(),
    )


def _heartbeat_fn(mesh):
    """The heartbeat collective of ``mesh``: a callable that all_reduces a
    rank's token and returns the mesh's sum."""
    def heartbeat(token):
        return int(mesh_lib.all_reduce_sum(token, mesh)[0])

    return heartbeat


def health_check(mesh=None, timeout_s: float = 30.0) -> dict:
    """All-reduce one token a rank over the mesh with a real collective, so
    a dead or hung peer shows as a timeout or a wrong count here rather
    than a stall inside a later collective.  The collective runs in a
    daemon thread, so ``timeout_s`` bounds the wait when a peer never
    comes.  Setup failures come back as a status dict too: it never
    raises.  Every rank of the mesh calls it."""
    try:
        if mesh is None:
            mesh = mesh_lib.make_mesh()
        token = torch.ones(1, dtype=torch.int64, device=mesh.device)
        heartbeat = _heartbeat_fn(mesh)
    except Exception as e:  # noqa: BLE001 - reported, as the check's job
        return {"ok": False, "error": f"heartbeat setup failed: {e}"}

    t0 = time.time()
    result: dict = {}

    def _run():
        try:
            result["total"] = heartbeat(token)
        except Exception as e:  # noqa: BLE001 - reported in the status
            result["error"] = str(e)

    th = threading.Thread(target=_run, daemon=True)
    th.start()
    th.join(timeout_s)
    elapsed = round(time.time() - t0, 3)
    if th.is_alive():
        return {"ok": False, "error": f"heartbeat timed out after "
                f"{timeout_s}s (dead or hung peer)", "elapsed_s": elapsed}
    if "error" in result:
        return {"ok": False, "error": result["error"], "elapsed_s": elapsed}
    return {"ok": result.get("total") == mesh.size, "devices": mesh.size,
            "heartbeat_total": result.get("total"),
            "process_count": mesh.size, "elapsed_s": elapsed}
