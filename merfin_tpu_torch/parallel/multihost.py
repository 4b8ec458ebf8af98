"""Multi-process launches over torch.distributed (port of
``merfin_tpu/parallel/multihost.py``).

The reference scales across nodes by Slurm file-scatter with a full DB
reload per node (scripts/parallel1, SURVEY §2.3).  Here each process
joins one torch.distributed job: processes read disjoint sequence (or DB
slice, or input block) stripes, and the host accumulators merge over a
gloo group, on f64/int64 CPU tensors gathered and summed in rank order,
so the sums are exact and the same on every rank.  A ``-mesh`` under a
multi-process launch spans every process's devices
(``make_global_mesh``); its probe sums ride gloo on the CPU and an NCCL
group on cards.

Environment contract (every process):

    MERFIN_NUM_PROCESSES  total process count
    MERFIN_PROCESS_ID     this process's rank (0-based)
    MERFIN_COORDINATOR    host:port of rank 0 (default 127.0.0.1:9876)
    MERFIN_DIST_TIMEOUT   seconds a collective may wait (optional; by
                          default 7 days, no practical deadline)

Ranks finish their stripes at different times (striping is by sequence
index, not by length), so the merges at the end of a run wait as long as
the slowest rank needs.  A rank that dies closes its connections, which
fails its peers' next collective; a test or a harness that must bound a
rank that hangs alive sets MERFIN_DIST_TIMEOUT.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

_env_initialized = False


def init(coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None) -> None:
    """Join the gloo process group (no-op when single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    timeout = os.environ.get("MERFIN_DIST_TIMEOUT")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=(datetime.timedelta(seconds=float(timeout)) if timeout
                 else datetime.timedelta(days=7)))


def maybe_init_from_env(log=None) -> bool:
    """Join a distributed job when MERFIN_NUM_PROCESSES > 1 (the
    torch.distributed analog of the reference's Slurm array scatter,
    scripts/parallel1/_submit_merfin.sh:57-70)."""
    global _env_initialized
    n = int(os.environ.get("MERFIN_NUM_PROCESSES", "1") or "1")
    if n <= 1:
        return False
    if not _env_initialized:
        init(coordinator=os.environ.get("MERFIN_COORDINATOR",
                                        "127.0.0.1:9876"),
             num_processes=n,
             process_id=int(os.environ.get("MERFIN_PROCESS_ID", "0")))
        _env_initialized = True
    if log is not None:
        pid, pcount = process_info()
        print(f"-- Joined distributed job: process {pid} of {pcount}.",
              file=log)
    return True


def is_active() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def barrier(name: str = "merfin") -> None:
    """Wait for every rank (``name`` labels the call site, as the JAX
    package's sync points do)."""
    if is_active():
        dist.barrier()


def process_info() -> tuple[int, int]:
    if not is_active():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _allgather(x: np.ndarray) -> np.ndarray:
    """[P, ...] stack of every rank's ``x`` (int64 or f64), by rank."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def global_devices() -> list[tuple[int, torch.device]]:
    """(rank, device) of every process's ``device.devices()``, by rank;
    every process must hold the same number."""
    from merfin_tpu_torch.device import devices

    local = devices()
    if not is_active():
        return [(0, d) for d in local]
    counts = _allgather(np.asarray([len(local)], np.int64)).reshape(-1)
    if not (counts == counts[0]).all():
        raise RuntimeError(f"processes hold unequal device counts "
                           f"{counts.tolist()}")
    return [(r, d) for r in range(len(counts)) for d in local]


def make_global_mesh(data: int | None = None):
    """A ("d", "t") mesh over ALL processes' devices, in rank order, split
    as ``sharded.make_mesh`` splits one process's.  Every rank creates the
    mesh's process groups here, together: on cards an NCCL group over
    every process, and for each row held by several processes a group of
    them (gloo on the CPU, NCCL on cards)."""
    from merfin_tpu_torch.parallel.sharded import Mesh, split_grid

    grid = split_grid(global_devices(), data)
    rank, _ = process_info()
    group, row_groups = None, {}
    if is_active():
        cuda = grid[0][0][1].type == "cuda"
        if cuda:
            torch.cuda.set_device(next(d for p, d in sum(grid, [])
                                       if p == rank))
            group = dist.new_group(backend="nccl")
        made = {}
        for r, row in enumerate(grid):
            holders = tuple(sorted({p for p, _ in row}))
            if len(holders) < 2:
                continue
            if holders not in made:    # every rank, in the same order
                made[holders] = (group if len(holders) == dist.get_world_size()
                                 else dist.new_group(
                                     list(holders),
                                     backend="nccl" if cuda else "gloo"))
            if rank in holders:
                row_groups[r] = made[holders]
    return Mesh([[d for _, d in row] for row in grid],
                ranks=[[p for p, _ in row] for row in grid], rank=rank,
                group=group, row_groups=row_groups)


def host_sequences(seq_iter):
    """Stripe sequences across processes: process i takes every P-th
    (the reference's scaffold striping, scripts/parallel1/merfin.sh:
    63-86, without the per-node DB duplication)."""
    pid, pcount = process_info()
    for i, seq in enumerate(seq_iter):
        if i % pcount == pid:
            yield seq


def merge_scalar_across_hosts(x: float) -> float:
    """Global sum of a host-local scalar (f64, summed in rank order)."""
    if not is_active():
        return float(x)
    return float(_allgather(np.asarray([x], np.float64)).sum())


def max_scalar_across_hosts(x: float) -> float:
    """Global max of a host-local scalar."""
    if not is_active():
        return float(x)
    return float(_allgather(np.asarray([x], np.float64)).max())


def allgather_scalar(x: float) -> np.ndarray:
    """Every rank's value of a host-local scalar, indexed by rank."""
    if not is_active():
        return np.asarray([x], dtype=np.float64)
    return _allgather(np.asarray([x], np.float64)).reshape(-1)


def merge_array_across_hosts(x: np.ndarray) -> np.ndarray:
    """Elementwise global sum of a host-local accumulator array."""
    if not is_active():
        return np.asarray(x)
    return _allgather(np.asarray(x)).sum(axis=0)
