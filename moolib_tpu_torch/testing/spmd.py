"""A world of SPMD worker processes: one ``torch.distributed`` process
group of N ranks that runs the same function on every rank and hands
the per-rank results back.

    with SpmdWorld(4, store_dir, backend="gloo", device="cpu") as world:
        outs = world.run(case, arg)     # [case(rank_ctx, arg) on rank r]

``case`` is a module-level function (it is pickled by name) taking a
:class:`Rank` and the arguments; it returns something picklable
(numpy arrays, numbers). The workers are spawned, rendezvous through a
``FileStore`` under ``store_dir`` (no port), keep running between calls
(one world serves many cases) and destroy their process group when the
world closes. A case that raises on any rank breaks the world: every
worker is stopped and the error, with the rank's traceback, raises
here, as does every later call.

The transport follows the backend and the device as
:mod:`~moolib_tpu_torch.parallel.collectives` says: ``gloo`` with
``device="cuda"`` is a world of ranks sharing the card, whose exchanges
pass through the host.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Rank", "SpmdWorld"]


class Rank:
    """What a case sees of its rank: ``rank``, ``world``, ``device`` (a
    ``torch.device``) and :meth:`mesh`, a cached ``make_mesh``."""

    def __init__(self, rank: int, world: int, device: str):
        import torch

        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self._meshes: Dict[tuple, Any] = {}

    def mesh(self, dp: Optional[int] = None, tp: int = 1, sp: int = 1,
             pp: int = 1, ep: int = 1):
        """The (dp, tp, sp, pp, ep) mesh over the whole world (made once
        per shape: a mesh creates a process group per axis)."""
        from ..parallel.mesh import make_mesh

        key = (dp, tp, sp, pp, ep)
        if key not in self._meshes:
            self._meshes[key] = make_mesh(dp, tp, sp, pp, ep,
                                          device=self.device)
        return self._meshes[key]


def _worker(rank: int, world: int, store_path: str, backend: str,
            device: str, timeout_s: float, conn) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    ctx = Rank(rank, world, device)
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args = msg
            try:
                conn.send(("ok", fn(ctx, *args)))
            except Exception:  # reported to the caller, who stops the world
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class SpmdWorld:
    def __init__(self, n: int, store_dir: str, backend: str = "gloo",
                 device: str = "cpu", timeout: float = 120.0):
        ctx = mp.get_context("spawn")
        os.makedirs(store_dir, exist_ok=True)
        store = os.path.join(store_dir, f"store-{os.getpid()}-{id(self)}")
        self.n, self.timeout = n, timeout
        self._broken: Optional[str] = None
        self._conns, self._procs = [], []
        for r in range(n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker, args=(r, n, store, backend,
                                                  device, timeout, child),
                            daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)

    def run(self, fn: Callable, *args, timeout: Optional[float] = None
            ) -> List[Any]:
        """``fn(rank_ctx, *args)`` on every rank; the results in rank
        order."""
        if self._broken is not None:
            raise RuntimeError(f"the world broke earlier: {self._broken}")
        for c in self._conns:
            c.send((fn, args))
        deadline = time.monotonic() + (timeout or self.timeout)
        results: List[Any] = [None] * self.n
        pending = set(range(self.n))
        while pending:
            for r in sorted(pending):
                c, p = self._conns[r], self._procs[r]
                if c.poll(0.01):
                    kind, value = c.recv()
                    if kind == "error":
                        self._break(f"rank {r} raised:\n{value}")
                    results[r] = value
                    pending.discard(r)
                elif not p.is_alive():
                    self._break(f"rank {r} died (exit code {p.exitcode})")
            if pending and time.monotonic() > deadline:
                self._break(f"ranks {sorted(pending)} did not answer "
                            f"{getattr(fn, '__name__', fn)} in time")
        return results

    def _break(self, why: str):
        self._broken = why
        self._stop(graceful=False)
        raise RuntimeError(why)

    def _stop(self, graceful: bool) -> None:
        if graceful:
            for c in self._conns:
                try:
                    c.send(None)
                except (BrokenPipeError, OSError):
                    pass
        for p in self._procs:
            p.join(timeout=30 if graceful else 0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for c in self._conns:
            c.close()
        self._conns = []

    def close(self) -> None:
        if self._conns:
            self._stop(graceful=self._broken is None)

    def __enter__(self) -> "SpmdWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
