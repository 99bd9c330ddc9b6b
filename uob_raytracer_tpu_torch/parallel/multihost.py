"""Multi-process initialization, failure detection, and a rank launcher.

The counterpart of ``uob_raytracer_tpu/parallel/multihost.py``. The
reference is strictly single-node with fail-fast error handling
(``checkError`` / ``die``, ``skeleton.cpp:499-515``); this module carries
the same philosophy to several processes: ranks rendezvous through
``torch.distributed.init_process_group``; a missing or dead rank surfaces
as a timeout here rather than a hang later, and everything after
initialization is the ordinary sharded path of ``parallel/render.py`` (the
mesh just spans more processes).

No elastic recovery is provided: like the reference, a failed participant
aborts the job.
"""
from __future__ import annotations

import datetime
import logging
import multiprocessing
import os
import time

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def transport(num_processes: int, n_cuda_devices: int) -> str:
    """The transport between ranks, from the devices alone: 'nccl' when
    every rank has a card of its own, 'gloo' otherwise (CPU ranks, or
    several ranks sharing a card, which NCCL refuses). It decides how bytes
    travel between ranks, never where a rank computes. The ranks are taken
    to share one host: ranks spread over several hosts with fewer cards
    each than ranks in all get gloo."""
    return "nccl" if n_cuda_devices >= num_processes else "gloo"


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         timeout_s: int = 120) -> bool:
    """Join the process group if a multi-process environment is given.

    ``coordinator`` (or the ``RAYTPU_COORDINATOR`` env var) is the
    rendezvous address: ``host:port``, or a ``tcp://`` / ``file://`` URL of
    ``torch.distributed``. Returns True after a successful rendezvous,
    False for the ordinary single-process case (no coordinator and no
    process count). Raises RuntimeError with a fail-fast diagnosis when the
    rendezvous fails or times out (e.g. a rank missing)."""
    coordinator = coordinator or os.environ.get("RAYTPU_COORDINATOR")
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_multihost needs the coordinator's address, the "
            "number of processes and this process's id: nothing tells a "
            "process of its cluster")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    backend = transport(num_processes, torch.cuda.device_count())
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    try:
        dist.init_process_group(
            backend, init_method=url, world_size=num_processes,
            rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
    except (RuntimeError, OSError, TimeoutError, ValueError) as e:
        # fail fast, with the reference's bluntness
        raise RuntimeError(
            f"multi-host rendezvous failed after {timeout_s}s — check that "
            f"every host in the slice is up and can reach "
            f"{coordinator!r}: {e}") from e
    log.info("multi-host initialized: process %d/%d over %s",
             dist.get_rank(), dist.get_world_size(), backend)
    return True


def global_mesh(dp: int | None = None, tp: int = 1):
    """This process's place in a ('dp','tp') mesh over all processes (call
    after initialize_multihost on every process)."""
    from .mesh import make_mesh
    return make_mesh(dp=dp, tp=tp)


def _rank_main(fn, rank: int, num_processes: int, url: str, timeout_s: int,
               args: tuple, failed_at) -> None:
    torch.set_num_threads(1)   # ranks share the host's cores
    initialize_multihost(url, num_processes, rank, timeout_s)
    try:
        fn(rank, *args)
    except BaseException:
        # the moment this rank failed, before its group goes down and the
        # ranks waiting on it fail in turn
        failed_at[rank] = time.monotonic()
        raise
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, num_processes: int, url: str, args: tuple = (),
                timeout_s: int = 60) -> None:
    """Run ``fn(rank, *args)`` in ``num_processes`` fresh processes (the
    ``spawn`` start method: safe after CUDA is initialised), each joined to
    one process group through ``initialize_multihost(url, ...)``. ``fn``
    must be importable (a module-level function). A rank that fails fails
    the run: the first non-zero exit, or ``timeout_s`` passing, kills the
    other ranks and raises RuntimeError naming the rank that failed first
    (the others may fail because it did, and exit before it)."""
    ctx = multiprocessing.get_context("spawn")
    failed_at = ctx.Array("d", [float("inf")] * num_processes)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, num_processes, url, timeout_s, args,
                               failed_at))
             for r in range(num_processes)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    failure = None
    try:
        while failure is None and any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                failure = "failed"
            elif time.monotonic() > deadline:
                failure = f"ranks still running after {timeout_s}s"
            time.sleep(0.05)
        if failure == "failed":
            # a moment for the rank that failed first to exit with its code
            grace = time.monotonic() + 5.0
            for p in procs:
                p.join(max(grace - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad and failure != f"ranks still running after {timeout_s}s":
        first = min(bad, key=lambda r: (failed_at[r], r))
        failure = f"rank {first} exited with code {procs[first].exitcode}"
    if failure is not None:
        raise RuntimeError(f"spawn_ranks: {failure}")
