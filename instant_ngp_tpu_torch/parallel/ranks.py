"""A pool of ranks on this host: one spawned process each, joined in one
default process group through a `FileStore` in a temporary directory (no
port, so several pools on one host never collide).

    with RankPool(4, backend="gloo") as pool:
        results = pool.run(fn, *args)     # fn(*args) on every rank

`fn` must be importable by the spawned processes (a module-level function
of a module they can import); its arguments and results are pickled by
value (plain `pickle`, so no tensor goes through shared memory), so they
are CPU tensors, arrays and plain values. A rank that raises sends its
traceback back and `run` raises with it; the other ranks may then wait in
a collective, so the pool is closed and a new one is needed. A rank whose
pool's process is gone exits. The tests keep one pool per file;
chip_smoke.py spawns its ranks through one too.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, List


def _rank_main(rank: int, world_size: int, backend: str, store_path: str,
               n_threads: int, parent: int, inbox, results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(n_threads)
    dist.init_process_group(backend,
                            store=dist.FileStore(store_path, world_size),
                            rank=rank, world_size=world_size)
    try:
        while True:
            try:
                job = inbox.get(timeout=1.0)
            except queue.Empty:
                if os.getppid() != parent:      # the pool's process died
                    break
                continue
            if job is None:
                break
            fn, args = pickle.loads(job)
            try:
                results.put((rank, True, pickle.dumps(fn(*args))))
            except Exception:   # the traceback goes back to the caller
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    #: seconds `run` waits for every rank's answer
    timeout = 600.0

    def __init__(self, world_size: int, backend: str = "gloo",
                 n_threads: int = 1):
        ctx = mp.get_context("spawn")
        self.world_size = world_size
        self._dir = tempfile.mkdtemp(prefix="ranks_")
        store = os.path.join(self._dir, "store")
        self._inboxes = [ctx.Queue() for _ in range(world_size)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main,
            args=(r, world_size, backend, store, n_threads, os.getpid(),
                  self._inboxes[r], self._results), daemon=True)
            for r in range(world_size)]
        for p in self._procs:
            p.start()
        self._broken = False

    def run(self, fn: Callable, *args: Any) -> List[Any]:
        """fn(*args) on every rank -> the results in rank order."""
        if self._broken:
            raise RuntimeError("a rank of this pool failed earlier")
        job = pickle.dumps((fn, args))
        for inbox in self._inboxes:
            inbox.put(job)
        out: List[Any] = [None] * self.world_size
        errors: List[str] = []
        n_answers, waited = 0, 0.0
        # until every rank has answered, one has failed (the others may
        # then wait for it in a collective) or a process is gone
        while n_answers < self.world_size and not errors \
                and waited < self.timeout:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead:
                    errors.append(f"ranks {dead} exited")
                continue
            n_answers += 1
            if ok:
                out[rank] = pickle.loads(value)
            else:
                errors.append(f"rank {rank}:\n{value}")
        if n_answers == self.world_size and not errors:
            return out
        self._broken = True
        self.close()
        raise RuntimeError("ranks failed or did not answer within "
                           f"{self.timeout} s:\n" + "\n".join(errors))

    def close(self) -> None:
        for p, inbox in zip(self._procs, self._inboxes):
            if p.is_alive():
                inbox.put(None)
        for p in self._procs:
            # a broken pool's ranks may wait in a collective for good
            p.join(timeout=1.0 if self._broken else 30.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
