"""Run one function on every rank of a new local process group.

``spawn(fn, world_size, backend, device, *args)`` starts ``world_size``
processes with ``torch.multiprocessing``'s spawn start method.  They meet
through a ``file://`` rendezvous in a fresh temporary directory, so
concurrent callers (test workers) never compete for a port.  Each rank runs
``fn(*args)`` inside the group and writes what it returns to a file, which
the caller reads back: ``spawn`` returns the ranks' results in rank order.
A rank that raises fails the call (the other ranks are stopped: they may
wait on it in a collective), and the error carries that rank's traceback.
CPU ranks use one intra-op thread each.  ``fn`` and ``args`` must be
picklable, and ``fn`` importable by name from the child process.

``device`` is "cpu" or "cuda"; CUDA ranks take card ``rank % count``, so
two ranks may share one card (over gloo: NCCL refuses two ranks on one
GPU).  Every process started is joined, or killed, before ``spawn``
returns.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, device: str,
               workdir: str, args: tuple) -> None:
    out = os.path.join(workdir, f"rank{rank}")
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        os.environ["LOCAL_RANK"] = str(rank)
        dist.init_process_group(backend, init_method=f"file://{workdir}/rendezvous",
                                rank=rank, world_size=world_size)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out + ".pkl")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, world_size: int, backend: str, device: str, *args: Any,
          timeout: Optional[float] = None) -> List[Any]:
    """``fn(*args)`` on ``world_size`` ranks over ``backend`` ("gloo" or
    "nccl"); returns each rank's result, in rank order.  ``timeout``
    (seconds) bounds the wait for the ranks; a rank still running then is
    killed and the call fails."""
    workdir = tempfile.mkdtemp(prefix="n2v_spawn_")
    ctx = mp.get_context("spawn")
    procs = []
    try:
        for rank in range(world_size):
            p = ctx.Process(target=_rank_main,
                            args=(rank, fn, world_size, backend, device, workdir, args),
                            daemon=False)
            p.start()
            procs.append(p)
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = {p.sentinel: p for p in procs}
        while pending:  # a rank that fails stops the wait: the others may block on it
            left = None if deadline is None else max(deadline - time.monotonic(), 0.0)
            ready = wait(list(pending), timeout=left)
            if not ready:
                break
            for s in ready:
                pending.pop(s).join()
            if any(p.exitcode != 0 for p in procs if p.exitcode is not None):
                break
        errors = []
        for rank, p in enumerate(procs):
            err = os.path.join(workdir, f"rank{rank}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {rank}:\n{f.read()}")
            elif p.exitcode is None:
                errors.append(f"rank {rank}: stopped while running (timeout {timeout} s, "
                              "or another rank failed)")
            elif p.exitcode != 0:
                errors.append(f"rank {rank}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("spawned ranks failed:\n" + "\n".join(errors))
        results = []
        for rank in range(world_size):
            with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)
