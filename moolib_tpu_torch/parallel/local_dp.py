"""Data parallelism over the local devices for one learner peer: the
counterpart of the reference ``train()``'s ``dp`` mesh over
``jax.devices()`` (``moolib_tpu/examples/vtrace/experiment.py:212-215``
and ``:506-507``; ``bench.py:86-95``).

The reference runs one controller over every local device: its learn
step is one ``shard_map`` over a ``dp`` mesh, ``dp = gcd(devices, learn
batch size)``. torch has no single controller over several cards, so
here it is one process per device (:class:`LocalDP`):

- rank 0 is the caller, the Accumulator's one peer (EnvPool, act step,
  batchers, checkpoint); it spawns ranks 1..dp-1, the followers, which
  never touch the broker;
- rank 0 drives the followers by commands: a small int64 header down
  each follower's pipe, then the payload over ``torch.distributed``:

  ``GRAD``   each follower receives only its own ``[T+1, B/dp, ...]``
             slice of the learn batch, every rank wraps its slice with
             :func:`~moolib_tpu_torch.parallel.distributed.
             host_local_batch_to_global` and runs the grad step on the
             mesh; rank 0 keeps the dp-mean gradients;
  ``STEP``   ``GRAD``, then every rank applies its own dp-mean gradients
             (the whole train step, the benchmark's);
  ``APPLY``  the reduced gradients broadcast from rank 0 as flat
             buckets, then every rank's apply step;
  ``STATE``  :func:`~moolib_tpu_torch.learner.replicate_state`;
  ``STOP``   each follower reports its kernel launches, its applied
             updates, its parameters' checksums and their running digest
             over its applies, and exits.

This is tier 1 of the reference's two tiers
(:mod:`~moolib_tpu_torch.parallel.distributed`): the Accumulator sees one
peer whatever ``dp`` is, so the virtual batch arithmetic is unchanged.

Backends: distinct cards get NCCL; ranks sharing a card, or on the CPU,
get gloo (NCCL refuses two ranks on one card; gloo moves card tensors
through the host, :func:`~moolib_tpu_torch.parallel.collectives.
transport`).

A follower that dies, raises or stops answering, or a rendezvous that
does not complete, makes rank 0 raise within ``TIMEOUT_S`` seconds with the
rank in the message; rank 0 raising or closing reaps every follower.
Nothing falls back to dp = 1.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing as mp
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import nest

__all__ = [
    "COMMANDS",
    "LocalDP",
    "choose_backend",
    "dp_size",
    "fold_digest",
    "param_checksums",
    "split_batch",
]

GRAD, STEP, APPLY, STATE, STOP = 1, 2, 3, 4, 5
COMMANDS = {GRAD: "GRAD", STEP: "STEP", APPLY: "APPLY", STATE: "STATE",
            STOP: "STOP"}
#: Offsets of the leaves in a packed slice are multiples of this.
_ALIGN = 16
#: :func:`fold_digest`'s multiplier (a prime; int64 wraps).
_DIGEST_MIX = 1_000_003
#: Seconds the rendezvous, a follower's start and every collective may
#: take before rank 0 raises.
TIMEOUT_S = 120.0
#: The world's start waits out three deadlines of ``TIMEOUT_S`` in turn
#: (every follower up, the rendezvous, every follower's learner), and each
#: raises and reaps; the watchdog over the start fires only past all
#: three and a reap, where one of them hung instead.
_START_WATCHDOG_S = 4 * TIMEOUT_S


def dp_size(devices: Sequence, batch_size: int) -> int:
    """The reference's rule: dp over as many local devices as the learn
    batch divides across, ``gcd(len(devices), batch_size)``."""
    return math.gcd(len(devices), int(batch_size))


def _card(d: torch.device) -> int:
    return 0 if d.index is None else d.index


def choose_backend(devices: Sequence) -> str:
    """``"nccl"`` for distinct cards, ``"gloo"`` for ranks that share a
    card or run on the CPU; raises for a mix of cards and the CPU."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds == {"cuda"}:
        cards = [_card(d) for d in devs]
        return "nccl" if len(set(cards)) == len(cards) else "gloo"
    raise ValueError(f"a dp world is all cards or all CPU, got "
                     f"{[str(d) for d in devs]}")


def _as_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _split_tree(tree, n: int, axis: int) -> list:
    def leaf(x):
        t = _as_tensor(x)
        if t.dim() <= axis:  # no batch axis: every rank gets it whole
            return [t] * n
        if t.shape[axis] % n:
            raise ValueError(f"batch axis {axis} of {tuple(t.shape)} does "
                             f"not split {n} ways")
        return list(t.chunk(n, axis))

    parts = [leaf(x) for x in nest.flatten(tree)]
    return [nest.unflatten_as(tree, [p[r] for p in parts]) for r in range(n)]


def split_batch(batch, n: int, batch_axis: int = 1,
                batch_axes: Optional[dict] = None) -> list:
    """``n`` slices of a host learn batch along its batch axes (views):
    slice ``r`` is rank ``r``'s, as :func:`~moolib_tpu_torch.parallel.
    mesh.shard_batch` would take it. Per-key axes as ``shard_batch``'s
    (``core_state`` on axis 0, the rest on ``batch_axis``)."""
    from .mesh import _resolve_batch_axes

    if isinstance(batch, dict):
        axes = _resolve_batch_axes(batch_axes, batch_axis)
        per_key = {k: _split_tree(v, n, axes.get(k, batch_axis))
                   for k, v in batch.items()}
        return [{k: per_key[k][r] for k in batch} for r in range(n)]
    return _split_tree(batch, n, batch_axis)


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _pack(tree) -> Tuple[tuple, torch.Tensor]:
    """``(spec, buffer)``: every leaf's bytes in one uint8 host buffer, and
    what :func:`_unpack` needs to view them again."""
    leaves = [_as_tensor(x).contiguous() for x in nest.flatten(tree)]
    meta, offset = [], 0
    for t in leaves:
        meta.append((tuple(t.shape), str(t.dtype).split(".")[-1], offset))
        offset = _aligned(offset + t.numel() * t.element_size())
    buf = torch.empty(offset, dtype=torch.uint8)
    for t, (_, _, off) in zip(leaves, meta):
        nb = t.numel() * t.element_size()
        if nb:
            buf[off:off + nb].copy_(t.cpu().reshape(-1).view(torch.uint8))
    structure = nest.map_structure(lambda _: 0, tree)
    return (structure, meta, offset), buf


def _unpack(spec: tuple, buf: torch.Tensor):
    structure, meta, _ = spec
    leaves = []
    for shape, dtype, off in meta:
        dtype = getattr(torch, dtype)
        nb = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        leaves.append(buf[off:off + nb].view(dtype).reshape(shape))
    return nest.unflatten_as(structure, leaves)


def param_checksums(model: torch.nn.Module) -> torch.Tensor:
    """Two int64 sums over the raw bits of every parameter, in order
    (plain, and weighted by position), on the parameters' device, without
    a wait: equal sums mean equal bytes, up to a collision of both. A few
    launches for each width of parameter, not for each parameter."""
    by_width: Dict[int, List[torch.Tensor]] = {}
    for p in model.parameters():
        flat = p.detach().reshape(-1)
        by_width.setdefault(flat.element_size(), []).append(flat.view(
            {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[flat.element_size()]))
    sums = torch.zeros(2, dtype=torch.int64,
                       device=next(model.parameters()).device)
    for width in sorted(by_width):
        bits = torch.cat(by_width[width])
        # The running sum's total weighs element i by len - i.
        sums = sums + torch.stack([
            bits.sum(dtype=torch.int64),
            bits.cumsum(0, dtype=torch.int64).sum()])
    return sums


def fold_digest(digest: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """``digest`` (two int64, zeros to start) folded with one more update's
    :func:`param_checksums` ``sums``: a running digest of the parameters
    after each update, in order, whose size is fixed however many updates
    it covers."""
    return digest * _DIGEST_MIX + sums


def _trainable(model) -> List[Tuple[str, torch.Tensor]]:
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def _init_opt_state(state) -> None:
    """Every parameter's optimizer state made now where the optimizer can
    (``init_state``, optax's ``init``): ``replicate_state`` broadcasts the
    tensors each rank holds, so every rank must hold the same ones."""
    init = getattr(state.optimizer, "init_state", None)
    if init is not None:
        init()


def _launches() -> Dict[str, int]:
    kernels = sys.modules.get("moolib_tpu_torch.ops._kernels")
    return {} if kernels is None else {
        k.name: k.launches for k in kernels.KERNELS}


class _Side:
    """What one rank holds: its device, the mesh, the data transport's
    device (the card under NCCL, the host under gloo)."""

    def __init__(self, device: torch.device, backend: str, mesh):
        self.device, self.mesh = device, mesh
        self.wire = device if backend == "nccl" else torch.device("cpu")

    def stage(self, tree):
        from ..ops.batcher import stage_batch

        return stage_batch(tree, self.device)

    def global_batch(self, local_host):
        from .distributed import host_local_batch_to_global

        return host_local_batch_to_global(self.mesh, self.stage(local_host))

    def broadcast_grads(self, model, host: Optional[dict]) -> dict:
        """The gradients, keyed by trainable parameter name, broadcast from
        rank 0 as one flat bucket per dtype over the wire; ``host`` is
        rank 0's (None on a follower, which receives). Returns them on
        the device."""
        from . import collectives

        named = _trainable(model)
        if host is None:
            tensors = [torch.empty(p.shape, dtype=p.dtype, device=self.wire)
                       for _, p in named]
        else:
            tensors = [_as_tensor(host[n]).to(self.wire, p.dtype)
                       for n, p in named]
        by_dtype: Dict[torch.dtype, list] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            bucket = collectives.flat_bucket(group)
            collectives.broadcast_(bucket, 0)
            if host is None:
                collectives.unflatten_into(bucket, group)
        return self.stage({n: t for (n, _), t in zip(named, tensors)})


def _follower(rank: int, devices: List[str], store_path: str, backend: str,
              timeout_s: float, build: Callable, args: tuple, conn) -> None:
    """Rank ``rank`` of a :class:`LocalDP` world: rendezvous, build the
    learner with ``build(device, mesh, *args) -> (state, grad_step,
    apply_step)``, then serve rank 0's commands until ``STOP`` (or until
    rank 0's end of the pipe closes)."""
    import torch.distributed as dist

    joined = False
    try:
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)  # a CPU world is a test world
        conn.send(("up", rank))
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, len(devices)),
            rank=rank, world_size=len(devices),
            timeout=datetime.timedelta(seconds=timeout_s))
        joined = True
        from .mesh import make_mesh

        side = _Side(device, backend, make_mesh(dp=len(devices),
                                                device=device))
        state, grad_step, apply_step = build(device, side.mesh, *args)
        _init_opt_state(state)
        conn.send(("ready", rank))
        updates, digest = 0, torch.zeros(2, dtype=torch.int64, device=device)
        local = None
        while True:
            try:
                header, spec = conn.recv()
            except EOFError:  # rank 0 is gone: nothing to report to
                return
            cmd, reuse = (int(x) for x in header)
            if cmd in (GRAD, STEP):
                if not reuse:
                    buf = torch.empty(spec[2], dtype=torch.uint8,
                                      device=side.wire)
                    dist.recv(buf, src=0)
                    local = side.global_batch(_unpack(spec, buf))
                grads, _ = grad_step(state.model, local)
                if cmd == STEP:
                    state = apply_step(state, grads)
                    updates += 1
                    digest = fold_digest(digest, param_checksums(state.model))
            elif cmd == APPLY:
                state = apply_step(state, side.broadcast_grads(
                    state.model, None))
                updates += 1
                digest = fold_digest(digest, param_checksums(state.model))
            elif cmd == STATE:
                _init_opt_state(state)
                from ..learner import replicate_state

                state = replicate_state(state, side.mesh)
            elif cmd == STOP:
                conn.send(("report", dict(
                    rank=rank, launches=_launches(), updates=updates,
                    checksums=param_checksums(state.model).cpu(),
                    digest=digest.cpu())))
                return
            else:
                raise RuntimeError(f"unknown dp command {cmd}")
    except Exception:  # reported to rank 0, which stops the world
        with contextlib.suppress(OSError):
            conn.send(("error", traceback.format_exc()))
        sys.exit(1)
    finally:
        if joined:
            dist.destroy_process_group()
        conn.close()


class LocalDP:
    """Rank 0's handle on a data-parallel world over ``devices`` (one
    process each, ``devices[0]`` this one's): spawns the followers, joins
    the default process group with them and lays the ``dp`` mesh over it
    (``.mesh``). ``build(device, mesh, *args)`` is called on every
    follower (a module-level function: it is pickled by name) and returns
    that rank's ``(state, grad_step, apply_step)``, built as the caller
    builds rank 0's with the same mesh; the parameters need not match
    until :meth:`replicate`.

    :data:`TIMEOUT_S` bounds the rendezvous and every collective; a follower
    found dead between commands fails the next one at once. ``start_s``
    is the seconds from the spawn to every follower's learner built;
    ``send_ms`` holds, per command name, the host milliseconds of each
    command's send (header and payload, not the step that follows)."""

    def __init__(self, devices: Sequence, build: Callable,
                 args: tuple = ()):
        import torch.distributed as dist

        from ..utils.benchmark import install_watchdog

        devices = [str(torch.device(d)) for d in devices]
        if len(devices) < 2:
            raise ValueError("a LocalDP world needs two devices or more; "
                             "dp = 1 is the plain step")
        if dist.is_initialized():
            raise RuntimeError("this process already has a default process "
                               "group; a LocalDP world needs its own")
        self.devices, self.dp = devices, len(devices)
        self.device = torch.device(devices[0])
        self.backend = choose_backend(devices)
        self.timeout = TIMEOUT_S
        self.send_ms: Dict[str, List[float]] = {
            name: [] for name in COMMANDS.values()}
        self.reports: List[dict] = []
        self.checksum_diff: Optional[int] = None
        self._broken: Optional[str] = None
        self._closed = False
        self._joined = False
        self._held = None
        self._procs: list = []
        self._conns: list = []
        t0 = time.perf_counter()
        self._store_dir = tempfile.mkdtemp(prefix="moolib-dp-")
        store = f"{self._store_dir}/store"
        watchdog = install_watchdog("local_dp_rendezvous", env_var=None,
                                    default_seconds=_START_WATCHDOG_S)
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            ctx = mp.get_context("spawn")
            for r in range(1, self.dp):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_follower, daemon=True,
                                name=f"dp-rank-{r}",
                                args=(r, devices, store, self.backend,
                                      self.timeout, build, tuple(args),
                                      child))
                p.start()
                child.close()
                self._procs.append(p)
                self._conns.append(parent)
            self._await("up", "started")
            try:
                dist.init_process_group(
                    self.backend, store=dist.FileStore(store, self.dp),
                    rank=0, world_size=self.dp,
                    timeout=datetime.timedelta(seconds=self.timeout))
                self._joined = True
                from .mesh import make_mesh

                self.mesh = make_mesh(dp=self.dp, device=self.device)
            except Exception as e:
                self._fail("the rendezvous", e)
            self._side = _Side(self.device, self.backend, self.mesh)
            # The followers' learners are built (a card's set-up, the
            # model) before the first command, whose send then times the
            # send alone.
            self._await("ready", "built its learner")
            self.start_s = time.perf_counter() - t0
        except BaseException:
            self._reap()
            raise
        finally:
            if watchdog is not None:
                watchdog.cancel()

    # -- liveness ---------------------------------------------------------------

    def _await(self, kind: str, what: str) -> None:
        """Every follower's ``kind`` message: "up" before the rendezvous
        (so one that dies while it starts, on an import or its card, is
        named at once), "ready" once its learner is built."""
        deadline = time.monotonic() + self.timeout
        pending = set(range(1, self.dp))
        while pending:
            for r in sorted(pending):
                conn, proc = self._conns[r - 1], self._procs[r - 1]
                if conn.poll(0.01):
                    got, value = self._recv(r, f"before it {what}")
                    if got == "error":
                        self._break(f"dp rank {r} raised before it {what}:"
                                    f"\n{value}")
                    if got != kind:
                        self._break(f"dp rank {r} sent {got!r} before it "
                                    f"{what}")
                    pending.discard(r)
                elif not proc.is_alive():
                    self._break(f"dp rank {r} died before it {what} (exit "
                                f"code {proc.exitcode})")
            if pending and time.monotonic() > deadline:
                self._break(f"dp ranks {sorted(pending)} had not {what} "
                            f"within {self.timeout:g} s")

    def _recv(self, r: int, when: str):
        """Follower ``r``'s next message; its pipe closing (it exited, or
        its spawn failed) breaks the world, naming the rank."""
        conn, proc = self._conns[r - 1], self._procs[r - 1]
        try:
            return conn.recv()
        except (EOFError, OSError):
            proc.join(timeout=5.0)
            self._break(f"dp rank {r} died {when} (exit code "
                        f"{proc.exitcode})")

    def _dead(self, grace: float = 0.0) -> List[str]:
        """What went wrong with each follower: a reported error or an exit,
        waiting up to ``grace`` seconds for one to show."""
        deadline = time.monotonic() + grace
        while True:
            found = []
            for r, (conn, proc) in enumerate(zip(self._conns, self._procs),
                                             start=1):
                with contextlib.suppress(EOFError, OSError):
                    if conn.poll():
                        kind, value = conn.recv()
                        if kind == "error":
                            found.append(f"dp rank {r} raised:\n{value}")
                            continue
                if not proc.is_alive():
                    found.append(f"dp rank {r} died (exit code "
                                 f"{proc.exitcode})")
            if found or time.monotonic() >= deadline:
                return found
            time.sleep(0.05)

    def _check(self) -> None:
        if self._closed:
            raise RuntimeError("the dp world is closed")
        if self._broken is not None:
            raise RuntimeError(f"the dp world broke earlier: {self._broken}")
        dead = self._dead()
        if dead:
            self._break("; ".join(dead))

    def _break(self, why: str):
        self._broken = why
        self._reap()
        raise RuntimeError(why)

    def _fail(self, what: str, exc: BaseException):
        dead = self._dead(grace=2.0)
        why = "; ".join(dead) if dead else (
            f"no follower died, none answered within {self.timeout:g} s "
            f"or the step raised on rank 0: {type(exc).__name__}: {exc}")
        self._broken = f"{what} failed: {why}"
        self._reap()
        raise RuntimeError(self._broken) from exc

    @contextlib.contextmanager
    def _command(self, cmd: int, spec=None, reuse: bool = False):
        """Send ``cmd``'s header (and ``spec``) to every follower; the body
        sends the payload and runs rank 0's part. Any failure breaks the
        world."""
        self._check()
        name = COMMANDS[cmd]
        try:
            t0 = time.perf_counter()
            header = np.array([cmd, int(reuse)], np.int64)
            for conn in self._conns:
                conn.send((header, spec))
            self._t0 = t0
            yield
        except Exception as e:  # the world is broken: reap, name the rank
            self._fail(f"dp {name}", e)

    def _sent(self, cmd: int) -> None:
        self.send_ms[COMMANDS[cmd]].append(
            1e3 * (time.perf_counter() - self._t0))

    # -- commands ---------------------------------------------------------------

    def _scatter(self, cmd: int, batch, reuse: bool):
        """Send every follower its slice of ``batch`` (or tell it to reuse
        the one it holds); returns rank 0's own slice as a global batch."""
        import torch.distributed as dist

        if reuse:
            if self._held is None:
                raise ValueError("no batch to reuse: send one first")
            with self._command(cmd, reuse=True):
                self._sent(cmd)
            return self._held
        slices = split_batch(batch, self.dp)
        packed = [_pack(s) for s in slices[1:]]
        with self._command(cmd, spec=packed[0][0]):
            works = [dist.isend(buf.to(self._side.wire), dst=r)
                     for r, (_, buf) in enumerate(packed, start=1)]
            for w in works:
                w.wait()
            self._sent(cmd)
            self._held = self._side.global_batch(slices[0])
        return self._held

    def grad(self, grad_step: Callable, model, batch, reuse: bool = False):
        """``GRAD``: ``grad_step(model, global_batch)`` on every rank over
        its slice of the host ``batch`` (``reuse``: the slices sent last);
        returns rank 0's ``(grads, metrics)``, the dp-mean gradients."""
        local = self._scatter(GRAD, batch, reuse)
        with self._command_body(GRAD):
            return grad_step(model, local)

    def step(self, grad_step: Callable, apply_step: Callable, state,
             batch, reuse: bool = False):
        """``STEP``: ``GRAD``, then every rank applies its own dp-mean
        gradients; returns rank 0's ``(state, metrics)``."""
        local = self._scatter(STEP, batch, reuse)
        with self._command_body(STEP):
            grads, metrics = grad_step(state.model, local)
            return apply_step(state, grads), metrics

    def apply(self, apply_step: Callable, state, grads: dict):
        """``APPLY``: ``grads`` (host or device tensors, or numpy arrays,
        keyed by trainable parameter name) broadcast to every rank, then
        every rank's ``apply_step``; returns rank 0's state."""
        with self._command(APPLY):
            staged = self._side.broadcast_grads(state.model, grads)
            self._sent(APPLY)
            return apply_step(state, staged)

    def replicate(self, state):
        """``STATE``: every rank takes rank 0's parameters, buffers,
        optimizer state and step; returns rank 0's state."""
        from ..learner import replicate_state

        with self._command(STATE):
            _init_opt_state(state)
            state = replicate_state(state, self.mesh)
            self._sent(STATE)
            return state

    @contextlib.contextmanager
    def _command_body(self, cmd: int):
        try:
            yield
        except Exception as e:
            self._fail(f"dp {COMMANDS[cmd]}", e)

    # -- the end ----------------------------------------------------------------

    def close(self, model: Optional[torch.nn.Module] = None) -> List[dict]:
        """``STOP``: every follower's report (``rank``, ``launches``,
        ``updates``, ``checksums`` of its parameters now, ``digest``: the
        :func:`fold_digest` of its parameters after each of its applies);
        then reaps the followers and leaves the process group. With rank
        0's ``model``, ``checksum_diff`` is the largest difference of a
        follower's checksums from its (0: the same bits). A broken world
        is only reaped. Idempotent."""
        if self._closed:
            return self.reports
        try:
            if self._broken is None:
                self._check()
                with self._command(STOP):
                    self._sent(STOP)
                self.reports = [self._report(r) for r in range(1, self.dp)]
                if model is not None:
                    mine = param_checksums(model).cpu()
                    self.checksum_diff = max(
                        int((r["checksums"] - mine).abs().max())
                        for r in self.reports)
        finally:
            self._reap()
        return self.reports

    def _report(self, r: int) -> dict:
        conn, proc = self._conns[r - 1], self._procs[r - 1]
        deadline = time.monotonic() + self.timeout
        while time.monotonic() < deadline:
            if conn.poll(0.05):
                kind, value = self._recv(r, "before its report")
                if kind == "report":
                    return value
                self._break(f"dp rank {r} raised:\n{value}")
            if not proc.is_alive():
                self._break(f"dp rank {r} died before its report (exit "
                            f"code {proc.exitcode})")
        self._break(f"dp rank {r} sent no report within {self.timeout:g} s")

    def _reap(self) -> None:
        """Stop every follower (they exit on STOP or when their pipe
        closes; in a broken world, or one that does not exit, they are
        terminated, then killed) and leave the process group."""
        import torch.distributed as dist

        if self._closed:
            return
        self._closed = True
        for conn in self._conns:
            conn.close()
        for p in self._procs:
            if self._broken is not None and p.is_alive():
                p.terminate()  # it may wait in a collective on this rank
        for p in self._procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        if self._joined:
            self._joined = False
            dist.destroy_process_group()
        shutil.rmtree(self._store_dir, ignore_errors=True)

    def __enter__(self) -> "LocalDP":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()
        else:
            self._reap()
