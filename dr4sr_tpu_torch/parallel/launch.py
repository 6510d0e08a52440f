"""Ranks as spawned processes of one host, for checks and small runs.

:func:`run_ranks` starts ``world`` processes (``spawn``), each of which
joins one process group through a ``FileStore`` (no port to pick, so
concurrent callers never collide), runs ``fn(rank, *args)`` and sends back
its result. The group, every collective and every join has a timeout, so a
hung collective fails the call instead of hanging it; a rank that raises
fails it with that rank's traceback, and every process is gone when it
returns. Results travel pickled by value. ``torchrun`` is the launcher for
real runs (``run.py``); this one serves ``chip_smoke.py`` and the tests,
whose ranks share one card or the CPU.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dr4sr_tpu_torch.parallel.mesh import init_distributed


def _entry(fn, rank, world, store_path, backend, timeout_s, device_type, args, results):
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)
        init_distributed(backend, store=dist.FileStore(store_path, world), rank=rank,
                         world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        # by value: a tensor sent through the queue as torch shares it (a
        # file descriptor) is gone once its rank has exited
        results.put((rank, None, pickle.dumps(fn(rank, *args))))
    except BaseException:  # sent to the caller, which raises on it
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, store_path: str, *args, backend: str = "gloo",
              device_type: str = "cpu", timeout_s: float = 300.0) -> list:
    """``fn(rank, *args)`` (a module-level function) on ``world`` ranks;
    the results in rank order. ``store_path`` is a file that must not exist
    yet. On ``device_type="cuda"`` rank r takes card r mod the card count."""
    if os.path.exists(store_path):
        raise FileExistsError(f"the store {store_path} exists already")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store_path, backend, timeout_s,
                                              device_type, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    outs, errors = {}, []
    try:
        for _ in procs:  # drained before any join
            try:
                rank, err, out = results.get(timeout=timeout_s)
            except queue.Empty:
                errors.append(f"a rank sent no result within {timeout_s} s")
                break
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            else:
                outs[rank] = pickle.loads(out)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [outs[r] for r in range(world)]
