"""A pool of ranks for the sharded code: spawned processes that join one
`torch.distributed` group and run the tasks they are given, in turn.

Each rank is a `multiprocessing` "spawn" process. It joins the group
through a `FileStore` (no TCP port), sets its torch threads and, for
CUDA, its device, then runs each task its parent sends, `fn(*args)` with
`fn` a module-level function, and sends back the result (a picklable host
object: numpy arrays, ints, bytes). `run` waits for every rank's result
until a deadline; a rank that fails, dies or overruns ends the whole pool
(its ranks killed) and raises, since the others may be blocked in a
collective. Nothing falls back to one device.

    pool = RankPool(4, "gloo", store_dir)      # four ranks on the CPU
    digests = pool.run(task, arg)              # task(arg) on every rank
    pool.close()

NCCL takes one rank a GPU (`devices=["cuda:0", "cuda:1", ...]`); gloo
ranks may share one card (`devices=["cuda:0"] * 4`), and exchange through
host memory.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pathlib
import queue
import time
import traceback
from typing import Optional, Sequence

__all__ = ["RankPool"]


def _rank_main(rank, world, backend, store_path, device, threads, timeout_s, tasks, results):
    """One rank: join the group, then run tasks until a None arrives."""
    try:
        import torch
        import torch.distributed as dist

        if threads:
            torch.set_num_threads(threads)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device).index or 0)
        dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, "ready", None))
    except Exception:  # reported to the parent, which fails
        results.put((rank, "error", traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, "ok", fn(*args)))
            except Exception:  # reported to the parent, which ends the pool
                results.put((rank, "error", traceback.format_exc()))
                return
    finally:
        dist.destroy_process_group()


class RankPool:
    """`world` ranks in one process group of `backend`, each started once
    and reused by every `run`. `devices` lists each rank's device (for
    CUDA, the rank sets it current; "cpu" or None leaves it unset);
    `threads` caps each rank's torch threads; `timeout` (seconds) is the
    default deadline of a `run` and of the start."""

    def __init__(self, world: int, backend: str, store_dir, devices: Optional[Sequence] = None,
                 threads: int = 1, timeout: float = 300.0):
        self.world, self.backend, self.timeout = world, backend, timeout
        self.devices = list(devices) if devices is not None else [None] * world
        if len(self.devices) != world:
            raise ValueError(f"{len(self.devices)} devices for {world} ranks")
        ctx = multiprocessing.get_context("spawn")
        store = pathlib.Path(store_dir) / f"store.{os.getpid()}.{time.monotonic_ns()}"
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, world, backend, str(store), self.devices[r], threads, timeout, self._tasks[r], self._results))
            for r in range(world)
        ]
        for p in self._procs:
            p.start()
        self._collect(timeout)

    def _collect(self, timeout: float) -> list:
        out, deadline = [None] * self.world, time.monotonic() + timeout
        left = set(range(self.world))
        while left:
            try:
                rank, kind, value = self._results.get(timeout=max(0.0, min(1.0, deadline - time.monotonic())))
            except queue.Empty:
                dead = [r for r in left if not self._procs[r].is_alive()]
                if dead or time.monotonic() >= deadline:
                    self.kill()
                    why = f"ranks {dead} died" if dead else f"ranks {sorted(left)} passed the {timeout:.0f} s deadline"
                    raise RuntimeError(f"rank pool ({self.backend}, {self.world} ranks): {why}")
                continue
            if kind == "error":
                self.kill()
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
            left.discard(rank)
        return out

    def run(self, fn, *args, timeout: Optional[float] = None) -> list:
        """fn(*args) on every rank; their results in rank order."""
        if not self.alive:
            raise RuntimeError("the rank pool was ended by an earlier failure")
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(self.timeout if timeout is None else timeout)

    @property
    def alive(self) -> bool:
        return all(p.is_alive() for p in self._procs)

    def kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(10)

    def close(self, timeout: float = 30.0) -> None:
        """Stop every rank: a clean exit within `timeout`, else killed."""
        if self.alive:
            for q in self._tasks:
                q.put(None)
            deadline = time.monotonic() + timeout
            for p in self._procs:
                p.join(max(0.0, deadline - time.monotonic()))
        self.kill()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
