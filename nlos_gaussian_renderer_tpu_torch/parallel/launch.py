"""Run a function on a local world of `torch.distributed` processes.

    results = spawn(fn, world=4, backend="gloo", timeout_s=120, args=(...))

Each rank is a fresh process (the `spawn` start method) that initialises
the default group from a file under a temporary directory of its own
(`init_method="file://..."`: concurrent worlds never share a port), calls
`fn(*args)` and sends back its result. `fn` and its arguments are pickled,
so `fn` is a module-level function the child imports by name. A rank that
raises, dies or outlasts `timeout_s` fails the whole world: the rest are
killed and `spawn` raises with the rank's traceback. With NCCL each rank
takes card `rank % device_count` before it joins.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Sequence


def _worker(fn, rank: int, world: int, backend: str, init_file: str, timeout_s: float,
            out, args) -> None:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        out.put((rank, result, None))
    except Exception:  # reported to the parent, which raises
        out.put((rank, None, traceback.format_exc()))


def spawn(fn: Callable, world: int, backend: str, timeout_s: float = 120.0,
          args: Sequence = ()) -> list:
    """[fn(*args) on rank r for r in range(world)]: `world` processes in one
    default group of `backend`, joined within `timeout_s` seconds."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="nlos_dist_") as tmp:
        out = ctx.Queue()
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(fn, r, world, backend, os.path.join(tmp, "init"),
                                   timeout_s, out, tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        results = {}
        try:
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} "
                                       f"did not finish within {timeout_s} s")
                try:
                    rank, result, err = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} without a result")
                    continue
                if err is not None:
                    raise RuntimeError(f"rank {rank} of {world} ({backend}) failed:\n{err}")
                results[rank] = result
        finally:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 0.1) if len(results) == world
                       else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
            out.close()
    return [results[r] for r in range(world)]
