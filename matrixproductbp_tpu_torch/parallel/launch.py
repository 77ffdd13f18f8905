"""Start ``torch.distributed`` ranks as spawned processes on one host.

:func:`spawn_ranks` runs ``fn(rank, world, *args)`` in ``world`` processes
started with the ``spawn`` method (a parent that has initialised CUDA
cannot fork), each a rank of one process group over a ``FileStore``, and
returns every rank's result.  The backend is the caller's: ``gloo`` on the
CPU, ``nccl`` with one rank a card, ``gloo`` where several ranks share a
card.  ``fn`` must be importable by its module path (a spawned process
starts from a fresh import), and what it returns is pickled back.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["spawn_ranks"]


def _rank_main(rank, world, fn, args, backend, store_path, threads, out):
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, store=dist.FileStore(store_path,
                                                              world),
                                rank=rank, world_size=world)
        try:
            res = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except Exception:
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn, world: int, args=(), backend: str = "gloo",
                threads: int | None = None, store_dir: str | None = None,
                timeout: float | None = None) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in a spawned process that is rank ``rank`` of a ``backend`` process
    group of ``world`` ranks (``threads``: torch's intra-op threads in each).
    The group meets in a ``FileStore`` in a new directory under
    ``store_dir`` (default: the system's temporary directory), removed
    afterwards.  Raises RuntimeError with the rank's traceback when a rank
    fails, dies or outlasts ``timeout`` seconds; every process started is
    ended before it returns or raises."""
    ctx = mp.get_context("spawn")
    run_dir = tempfile.mkdtemp(prefix="ranks_", dir=store_dir)
    store_path = os.path.join(run_dir, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, fn, args, backend, store_path, threads, out))
        for r in range(world)]
    results, error = {}, None
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) < world and error is None:
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results]
                if dead:
                    error = f"rank {dead[0]} exited with code " \
                            f"{procs[dead[0]].exitcode} and no result"
                elif deadline is not None and time.monotonic() > deadline:
                    error = f"ranks did not finish within {timeout} s"
                continue
            if ok:
                results[rank] = res
            else:
                error = f"rank {rank} failed:\n{res}"
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        shutil.rmtree(run_dir, ignore_errors=True)
    if error is not None:
        raise RuntimeError(error)
    return [results[r] for r in range(world)]
