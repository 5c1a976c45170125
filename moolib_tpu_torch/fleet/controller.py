"""Fleet controller: materialize a spec, supervise the roles, survive;
the counterpart of :mod:`moolib_tpu.fleet.controller`.

The controller peer turns a :class:`~moolib_tpu_torch.fleet.spec.FleetSpec`
into a live cohort and keeps it that way:

- **Materialization** — every role (broker + standbys, learner members,
  env workers, serving replicas, routers) is spawned in-process (its own
  :class:`~moolib_tpu_torch.rpc.Rpc` peer on a loopback OS port) or as a
  subprocess (``python -m moolib_tpu_torch.fleet.runner``, the production
  shape, started with ``subprocess.Popen`` so a child never inherits a
  forked CUDA context; the controller itself touches no CUDA). The
  replicas serve on ``device``: the card unless the caller names
  another; a subprocess replica's role descriptor names it. Each role peer defines the ``fleet.ping`` / ``fleet.role_info``
  wire family, so supervision and adoption observe roles the same way
  regardless of backend.
- **Supervision** — the EnvPool restart-budget idiom at fleet scale:
  ``probe_misses`` consecutive missed health
  probes declare a role dead; deaths are respawned under
  capped-exponential full-jitter backoff, and more than
  ``restart_limit`` deaths inside ``restart_window_s`` degrade the role
  to *permanently down* — a dead replica is then
  :meth:`~moolib_tpu_torch.serving.router.Router.forget_replica`'d from every
  router so the fleet routes around the corpse. Probe misses are
  mirrored into the telemetry registry (``fleet_probe_misses_total``),
  so the health signal supervision acts on is the same signal operators
  scrape.
- **Survivability** — the controller itself is a failure domain. The
  observed cohort state lives in a :class:`Cohort` (the in-process
  stand-in for gossip + statestore) that a standby controller shares;
  when the primary dies mid-rollout the standby *adopts*: it verifies it
  can observe a majority of the live roles (a minority view must not
  seize the fleet — the same refusal broker promotion makes), CASes the
  cohort's controller epoch up by one (the fence: a zombie primary's
  next fenced action sees the lost epoch and stops; a second adopt of
  the same epoch is a no-op), takes over supervision of the roles that
  exist (never re-spawning a live one), and resumes any in-flight
  rollout so a canary is never orphaned.

Every transition is a typed ``fleet_*`` flight event and a
``fleet_*`` metric.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import subprocess
import sys
import threading
import time
import weakref
from collections import deque
from random import Random
from typing import Any, Callable, Dict, List, Optional

from ..rpc import Rpc, RpcError
from ..rpc.broker import Broker
from ..utils import get_logger
from .rollout import Rollout
from .spec import FleetSpec

__all__ = ["AdoptError", "Cohort", "Controller", "RoleHandle",
           "default_model"]

log = get_logger("fleet")


class AdoptError(RuntimeError):
    """Standby adoption refused: fenced by a newer epoch, or the standby
    could not observe a majority of the live roles."""


def _scale_model(p, x):
    """The toy serving model of the fleet and of the chaos scenarios,
    ``x * p["scale"]`` on ``x``'s device: a scale published over the
    wire arrives as a 0-d numpy array, and ``tensor * ndarray`` is
    numpy's multiply, which reads a card tensor back to the host and
    fails."""
    import torch

    return x * torch.as_tensor(p["scale"], device=x.device)


def default_model():
    """The canonical toy serving model (matches the chaos harness): a
    numpy scale so fleet machinery, not arithmetic, is measured."""
    import numpy as np

    params = {"scale": np.float32(2.0)}
    return _scale_model, params


class RoleHandle:
    """One supervised role: identity, backend, liveness bookkeeping.

    All mutable fields are guarded by the owning :class:`Cohort`'s lock
    (one supervisor mutates, adoption reads)."""

    def __init__(self, name: str, kind: str, backend: str = "in_process"):
        self.name = name
        self.kind = kind  # broker | learner | envworker | replica | router
        self.backend = backend
        self.status = "up"  # up | restarting | down
        self.rpc: Optional[Rpc] = None
        self.obj: Any = None  # Broker / Replica / Router / None
        self.proc: Optional[subprocess.Popen] = None
        self.addr: Optional[str] = None
        self.misses = 0
        self.deaths: deque = deque()
        self.spawns = 0
        self.respawn_at: Optional[float] = None

    def summary(self) -> Dict[str, Any]:
        return {"kind": self.kind, "backend": self.backend,
                "status": self.status, "spawns": self.spawns,
                "strikes": len(self.deaths), "addr": self.addr}


class Cohort:
    """The observed cohort state both controllers share: the epoch
    fence, the role registry, the model-version registry, and the
    in-flight rollout record. In-process this is one lock-guarded
    object; across hosts the same record rides gossip + the
    statestore."""

    def __init__(self):
        self.lock = threading.Lock()
        self.epoch = 0
        self.controller: Optional[str] = None
        self.heartbeat = time.monotonic()
        self.roles: Dict[str, RoleHandle] = {}
        self.models: Dict[int, Any] = {}
        self.current_version: Optional[int] = None
        self.rollout: Optional[Dict[str, Any]] = None
        self._closed = False

    def install_epoch(self, epoch: int, controller: str) -> bool:
        """The fence CAS: installs ``epoch`` iff it is strictly newer.
        Returns False (refused) otherwise — a stale adopter or a zombie
        primary can never move the fleet backwards."""
        with self.lock:
            if epoch <= self.epoch:
                return False
            self.epoch = epoch
            self.controller = controller
            self.heartbeat = time.monotonic()
            return True

    def fenced(self, epoch: int, controller: str) -> bool:
        with self.lock:
            return self.epoch == epoch and self.controller == controller

    def close(self) -> None:
        """Tear down every role (idempotent): the cohort owns the role
        objects; controllers own only their own threads + Rpc."""
        with self.lock:
            if self._closed:
                return
            self._closed = True
            handles = list(self.roles.values())
        for h in handles:
            _close_role(h)


def _close_role(h: RoleHandle) -> None:
    """Best-effort full teardown of one role's resources (idempotent —
    every close below is)."""
    if h.obj is not None:
        try:
            h.obj.close()
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except Exception as e:  # pragma: no cover - defensive
            log.debug("closing %s object: %s", h.name, e)
        h.obj = None
    if h.rpc is not None:
        h.rpc.close()
        h.rpc = None
    if h.proc is not None:
        try:
            h.proc.terminate()
            h.proc.wait(timeout=5)
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except Exception:
            h.proc.kill()
            h.proc.wait(timeout=5)
        h.proc = None


def _supervise_entry(wref, stop, tick_s):
    """Supervisor-thread entry (the weakref thread contract): holds the Controller only for one tick, so an
    abandoned controller stays collectable."""
    while not stop.wait(tick_s):
        ctl = wref()
        if ctl is None:
            return
        if not ctl._tick():
            return
        del ctl  # do not pin across the wait


def _standby_entry(wref, stop, tick_s):
    """Standby watch-thread entry (weakref contract): adopt the fleet
    when the primary's cohort heartbeat goes stale."""
    while not stop.wait(tick_s):
        ctl = wref()
        if ctl is None:
            return
        if not ctl._standby_tick():
            return
        del ctl


class Controller:
    """Materializes and supervises one fleet.

    ``Controller(spec)`` is a primary: ``materialize()`` spawns every
    role and starts supervision. ``Controller(spec, cohort=...,
    standby=True)`` is a standby: it idles watching the shared cohort's
    heartbeat and adopts on primary silence (or when :meth:`adopt` is
    called explicitly). ``device`` is where the replicas serve: None is
    the card (a replica raises without one), ``"cpu"`` the CPU."""

    def __init__(self, spec: FleetSpec, *, name: str = "ctl0",
                 cohort: Optional[Cohort] = None, standby: bool = False,
                 model: Optional[Callable] = None, params: Any = None,
                 version: int = 1, seed: int = 0,
                 failover_after_s: float = 1.0, backend: str = "in_process",
                 incident_dir: Optional[str] = None, device=None):
        spec.validate()
        if backend not in ("in_process", "subprocess"):
            raise ValueError(f"unknown backend {backend!r}")
        self.spec = spec
        self.name = name
        self.standby = bool(standby)
        self.backend = backend
        self.cohort = cohort if cohort is not None else Cohort()
        self._incident_dir = incident_dir
        self._device = device
        self._rng = Random(seed)
        self._failover_after = float(failover_after_s)
        if model is None and params is None:
            model, params = default_model()
        self._model = model
        with self.cohort.lock:
            if self.cohort.current_version is None:
                self.cohort.models[int(version)] = params
                self.cohort.current_version = int(version)
        self._epoch = 0
        self._stop = threading.Event()
        self._killed = threading.Event()
        self._closed = False
        self._supervisor: Optional[threading.Thread] = None
        self._watcher: Optional[threading.Thread] = None
        self._rollout_thread: Optional[threading.Thread] = None
        self._rollout: Optional[Rollout] = None
        self._last_probe = 0.0

        self.rpc = Rpc(name)
        self.rpc.listen("127.0.0.1:0")
        if self.rpc.defined("fleet.status"):  # pragma: no cover
            raise RpcError("fleet.status already defined on this peer")
        self.rpc.define("fleet.status", self.status)
        tel = self.rpc.telemetry
        self._tel = tel
        reg = tel.registry
        f = spec.name
        self._m_roles = reg.gauge("fleet_roles", fleet=f)
        self._m_roles_down = reg.gauge("fleet_roles_down", fleet=f)
        self._m_restarts = reg.counter("fleet_restarts_total", fleet=f)
        self._m_down = reg.counter("fleet_role_down_total", fleet=f)
        self._m_adoptions = reg.counter("fleet_adoptions_total", fleet=f)
        self._m_probe_miss = reg.counter("fleet_probe_misses_total",
                                         fleet=f)
        if self.standby:
            self._watcher = threading.Thread(
                target=_standby_entry,
                args=(weakref.ref(self), self._stop,
                      min(0.05, self._failover_after / 4)),
                name=f"{name}-standby", daemon=True,
            )
            self._watcher.start()

    # -- materialization -----------------------------------------------------

    def materialize(self) -> None:
        """Spawn every role the spec names and start supervising. Only a
        primary materializes; the fence epoch is installed first so a
        competing controller can never spawn a second copy."""
        if self.standby:
            raise AdoptError("a standby must adopt, not materialize")
        if not self.cohort.install_epoch(1, self.name):
            raise AdoptError(
                "cohort already has a controller (epoch "
                f"{self.cohort.epoch}); a second materialize would "
                "double-spawn every role"
            )
        self._epoch = 1
        spec = self.spec
        for i in range(1 + spec.broker.standbys):
            self._spawn(f"{spec.name}-broker{i}", "broker")
        for i in range(spec.learners.n):
            self._spawn(f"{spec.name}-learner{i}", "learner")
        for i in range(spec.env_workers.n):
            self._spawn(f"{spec.name}-env{i}", "envworker")
        for i in range(spec.serving.replicas):
            self._spawn(f"{spec.name}-rep{i}", "replica")
        for i in range(spec.serving.routers):
            self._spawn(f"{spec.name}-router{i}", "router")
        self._start_supervisor()

    def _spawn(self, name: str, kind: str,
               handle: Optional[RoleHandle] = None) -> RoleHandle:
        """Create (or re-create, on restart) one role. The handle is
        registered under the cohort lock; the role's resources are built
        outside it (spawning must not block adoption reads)."""
        if handle is None:
            handle = RoleHandle(name, kind, backend=self._backend_for(kind))
        try:
            if handle.backend == "subprocess":
                self._spawn_subprocess(handle)
            else:
                self._spawn_in_process(handle)
        except BaseException:
            _close_role(handle)  # a half-built role leaks no peer
            raise
        with self.cohort.lock:
            handle.status = "up"
            handle.misses = 0
            handle.respawn_at = None
            handle.spawns += 1
            self.cohort.roles[handle.name] = handle
        if self._tel.on:
            fr = self._tel.flight
            if fr.on:
                fr.record("fleet_spawn", fleet=self.spec.name,
                          role=name, kind=kind, backend=handle.backend)
        self._refresh_role_gauges()
        return handle

    def _backend_for(self, kind: str) -> str:
        # Routers stay in-process even under the subprocess backend:
        # the router object is the rollout's canary-dispatch surface and
        # must be drivable by the controller that owns the rollout.
        if self.backend == "subprocess" and kind != "router":
            return "subprocess"
        return "in_process"

    def _role_endpoints(self, rpc: Rpc, handle: RoleHandle) -> None:
        """The fleet wire family every role serves. Construction-time
        collision refusal, like the serving tier."""
        for ep in ("fleet.ping", "fleet.role_info"):
            if rpc.defined(ep):
                raise RpcError(
                    f"endpoint {ep!r} already defined on peer "
                    f"{rpc.get_name()!r} — refusing to shadow it"
                )
        info = {"fleet": self.spec.name, "role": handle.name,
                "kind": handle.kind}
        rpc.define("fleet.ping", lambda: "pong")
        rpc.define("fleet.role_info", lambda: dict(info))

    def _spawn_in_process(self, handle: RoleHandle) -> None:
        from ..serving import Replica, Router

        spec = self.spec
        rpc = Rpc(handle.name)
        rpc.listen("127.0.0.1:0")
        handle.rpc = rpc
        handle.addr = rpc.debug_info()["listen"][0]
        self._role_endpoints(rpc, handle)
        if handle.kind == "broker":
            handle.obj = Broker(rpc)
        elif handle.kind == "replica":
            version, params = self._current_model()
            handle.obj = Replica(
                rpc, self._model, params, version=version,
                service=spec.serving.service,
                batch_size=spec.serving.batch_size,
                max_queue=spec.serving.max_queue, device=self._device,
            )
        elif handle.kind == "router":
            sup = spec.supervision
            rep_handles = self._roles_of_kind("replica")
            for rh in rep_handles:
                if rh.addr:
                    rpc.connect(rh.addr)
            handle.obj = Router(
                rpc, [rh.name for rh in rep_handles],
                service=spec.serving.service,
                attempt_timeout_s=1.0,
                probe_interval_s=sup.probe_interval_s,
                probe_timeout_s=sup.probe_timeout_s,
                probe_misses=sup.probe_misses,
                seed=self._rng.randrange(1 << 30),
            )
        # learner/envworker: a member peer with the fleet wire family —
        # the training wiring itself rides the examples.
        self.rpc.connect(handle.addr)

    def _spawn_subprocess(self, handle: RoleHandle) -> None:
        spec = self.spec
        desc = {"name": handle.name, "kind": handle.kind,
                "fleet": spec.name, "service": spec.serving.service,
                "batch_size": spec.serving.batch_size,
                "max_queue": spec.serving.max_queue,
                "version": self._current_model()[0],
                "device": (None if self._device is None
                           else str(self._device))}
        proc = subprocess.Popen(
            [sys.executable, "-m", "moolib_tpu_torch.fleet.runner",
             "--role", json.dumps(desc)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True,
        )
        handle.proc = proc
        deadline = time.monotonic() + 60.0
        addr = None
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("FLEET_ADDR "):
                addr = line.split(None, 1)[1].strip()
                break
        if addr is None:
            _close_role(handle)
            raise RpcError(
                f"subprocess role {handle.name!r} never announced its "
                "address"
            )
        handle.addr = addr
        self.rpc.connect(addr)

    def _current_model(self):
        with self.cohort.lock:
            v = self.cohort.current_version
            return v, self.cohort.models[v]

    def _roles_of_kind(self, kind: str) -> List[RoleHandle]:
        with self.cohort.lock:
            return [h for h in self.cohort.roles.values()
                    if h.kind == kind]

    def _routers(self) -> List[Any]:
        return [h.obj for h in self._roles_of_kind("router")
                if h.obj is not None and h.status == "up"]

    def router(self):
        """The first live router object (the canonical client surface
        for in-process fleets); None when the spec has no routers."""
        routers = self._routers()
        return routers[0] if routers else None

    # -- supervision ---------------------------------------------------------

    def _start_supervisor(self) -> None:
        if self._supervisor is not None and self._supervisor.is_alive():
            return
        self._supervisor = threading.Thread(
            target=_supervise_entry,
            args=(weakref.ref(self), self._stop, 0.02),
            name=f"{self.name}-supervise", daemon=True,
        )
        self._supervisor.start()

    def _tick(self) -> bool:
        """One supervisor tick: pump brokers, heartbeat the cohort,
        probe on the probe cadence, run due respawns. Returns False to
        stop the thread (killed, or fenced out by a newer epoch)."""
        if self._killed.is_set():
            return False
        if not self.cohort.fenced(self._epoch, self.name):
            # A newer controller adopted while we still ran: we are the
            # zombie the fence exists for. Stop before mutating anything.
            log.warning("%s: fenced out (epoch moved past %d); stopping",
                        self.name, self._epoch)
            return False
        for h in self._roles_of_kind("broker"):
            if h.obj is not None and h.status == "up":
                h.obj.update()
        with self.cohort.lock:
            self.cohort.heartbeat = time.monotonic()
        now = time.monotonic()
        if now - self._last_probe >= self.spec.supervision.probe_interval_s:
            self._last_probe = now
            self._probe_all()
        self._run_due_respawns()
        return True

    def _probe_all(self) -> None:
        """One async probe sweep over every up role: send all pings,
        then collect within one shared probe deadline — bounded by
        ``probe_timeout_s`` regardless of fleet size."""
        sup = self.spec.supervision
        with self.cohort.lock:
            targets = [h for h in self.cohort.roles.values()
                       if h.status == "up"]
        futs = []
        for h in targets:
            # A subprocess corpse needs no probe round-trip to diagnose.
            if h.proc is not None and h.proc.poll() is not None:
                futs.append((h, None))
                continue
            try:
                futs.append((h, self.rpc.call_with_deadline(
                    h.name, "fleet.ping", sup.probe_timeout_s)))
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # never swallow task cancellation
            except (RpcError, TimeoutError):
                futs.append((h, None))  # unroutable: an immediate miss
        deadline = time.monotonic() + sup.probe_timeout_s + 2.0
        for h, fut in futs:
            ok = False
            if fut is not None:
                try:
                    fut.result(timeout=max(0.01,
                                           deadline - time.monotonic()))
                    ok = True
                except (asyncio.CancelledError,
                        concurrent.futures.CancelledError):
                    raise  # never swallow task cancellation
                except (RpcError, TimeoutError):
                    ok = False
            with self.cohort.lock:
                if ok:
                    h.misses = 0
                    continue
                h.misses += 1
                misses = h.misses
            if self._tel.on:
                self._m_probe_miss.inc()
            if misses >= sup.probe_misses:
                self._on_role_death(h)

    def _on_role_death(self, h: RoleHandle) -> None:
        """Death -> restart budget decision (the EnvPool idiom): prune
        the death window, then either schedule a backed-off respawn or
        degrade to permanently down."""
        sup = self.spec.supervision
        now = time.monotonic()
        with self.cohort.lock:
            if h.status != "up":
                return
            h.deaths.append(now)
            while h.deaths and now - h.deaths[0] > sup.restart_window_s:
                h.deaths.popleft()
            strikes = len(h.deaths)
            over_budget = strikes > sup.restart_limit
            h.status = "down" if over_budget else "restarting"
            if not over_budget:
                ceiling = min(sup.backoff_cap_s,
                              sup.backoff_base_s * (2 ** (strikes - 1)))
                h.respawn_at = now + self._rng.uniform(0.0, ceiling)
        _close_role(h)
        fr = self._tel.flight
        if over_budget:
            log.error("fleet %s: role %s permanently down after %d "
                      "strikes", self.spec.name, h.name, strikes)
            if self._tel.on:
                self._m_down.inc()
                if fr.on:
                    fr.record("fleet_down", fleet=self.spec.name,
                              role=h.name, strikes=int(strikes))
            if h.kind == "replica":
                for router in self._routers():
                    router.forget_replica(h.name)
        else:
            log.warning("fleet %s: role %s died (strike %d/%d); "
                        "respawning", self.spec.name, h.name, strikes,
                        sup.restart_limit)
            if self._tel.on:
                self._m_restarts.inc()
                if fr.on:
                    fr.record("fleet_restart", fleet=self.spec.name,
                              role=h.name, strikes=int(strikes))
        self._refresh_role_gauges()

    def _run_due_respawns(self) -> None:
        now = time.monotonic()
        with self.cohort.lock:
            due = [h for h in self.cohort.roles.values()
                   if h.status == "restarting"
                   and h.respawn_at is not None and now >= h.respawn_at]
        for h in due:
            try:
                self._spawn(h.name, h.kind, handle=h)
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # never swallow task cancellation
            except Exception as e:
                log.error("respawn of %s failed (%s); counting as a "
                          "death", h.name, e)
                with self.cohort.lock:
                    h.status = "up"  # so the death accounting applies
                self._on_role_death(h)
                continue
            if h.kind == "replica":
                # Routers reconnect to the respawned peer's new port and
                # keep its (same) name in rotation.
                for rh in self._roles_of_kind("router"):
                    if rh.obj is not None and rh.rpc is not None:
                        rh.rpc.connect(h.addr)

    def _refresh_role_gauges(self) -> None:
        if not self._tel.on:
            return
        with self.cohort.lock:
            up = sum(1 for h in self.cohort.roles.values()
                     if h.status != "down")
            down = sum(1 for h in self.cohort.roles.values()
                       if h.status == "down")
        self._m_roles.set(up)
        self._m_roles_down.set(down)

    # -- standby + adoption --------------------------------------------------

    def _standby_tick(self) -> bool:
        if self._killed.is_set() or self._epoch > 0:
            return False  # adopted (or dead): the watch is over
        with self.cohort.lock:
            stale = time.monotonic() - self.cohort.heartbeat
            has_primary = self.cohort.epoch > 0
        if has_primary and stale > self._failover_after:
            try:
                self.adopt()
            except AdoptError as e:
                log.warning("%s: adoption refused (%s); keep watching",
                            self.name, e)
        return self._epoch == 0

    def adopt(self) -> Dict[str, Any]:
        """Take over the fleet from a dead primary.

        Fenced like broker promotion: requires observing a majority of
        the fleet's non-down roles (a partitioned standby must not seize
        a fleet it cannot see), then CASes the cohort epoch up by one —
        a concurrent adopter loses the CAS and raises; calling adopt
        again after winning is a no-op (``{"already": True}``), so
        double-adopt can never double-spawn. Resumes any in-flight
        rollout (fresh settle window) so the canary completes or rolls
        back instead of being orphaned."""
        with self.cohort.lock:
            if (self.cohort.controller == self.name
                    and self.cohort.epoch == self._epoch
                    and self._epoch > 0):
                return {"already": True, "epoch": self._epoch}
            proposed = self.cohort.epoch + 1
            candidates = [h for h in self.cohort.roles.values()
                          if h.status != "down"]
        observed = []
        for h in candidates:
            try:
                if h.addr:
                    self.rpc.connect(h.addr)
                fut = self.rpc.call_with_deadline(
                    h.name, "fleet.ping",
                    self.spec.supervision.probe_timeout_s)
                fut.result(
                    timeout=self.spec.supervision.probe_timeout_s + 2.0)
                observed.append(h.name)
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # never swallow task cancellation
            except (RpcError, TimeoutError):
                continue
        if len(observed) * 2 <= len(candidates):
            raise AdoptError(
                f"observed only {len(observed)}/{len(candidates)} live "
                "roles — refusing to adopt from a minority view"
            )
        if not self.cohort.install_epoch(proposed, self.name):
            raise AdoptError(
                f"fenced: epoch moved to {self.cohort.epoch} while "
                f"adopting {proposed}"
            )
        self._epoch = proposed
        self.standby = False
        if self._tel.on:
            self._m_adoptions.inc()
            fr = self._tel.flight
            if fr.on:
                fr.record("fleet_adopt", fleet=self.spec.name,
                          controller=self.name, epoch=proposed,
                          roles=sorted(observed))
        log.warning("%s adopted fleet %s at epoch %d (%d roles observed)",
                    self.name, self.spec.name, proposed, len(observed))
        self._start_supervisor()
        self._resume_rollout()
        return {"already": False, "epoch": proposed,
                "roles": sorted(observed)}

    def _resume_rollout(self) -> None:
        with self.cohort.lock:
            rec = dict(self.cohort.rollout) if self.cohort.rollout else None
        if rec is None or rec["state"] not in ("canary", "settling"):
            return
        log.warning("%s: resuming in-flight rollout of v%d (was %s)",
                    self.name, rec["version"], rec["state"])
        self.start_rollout(
            version=rec["version"], wait=False,
            prior_version=rec["prior_version"],
        )

    # -- rollout -------------------------------------------------------------

    def publish_model(self, params: Any, version: int) -> None:
        """Register ``params`` as ``version`` in the cohort's model
        registry (the rollout publishes out of it; rollback returns to
        the prior entry)."""
        with self.cohort.lock:
            self.cohort.models[int(version)] = params

    def start_rollout(self, params: Any = None, version: int = 0, *,
                      wait: bool = True, reward_fn=None,
                      prior_version: Optional[int] = None,
                      store=None):
        """Roll ``version`` out through the canary state machine
        (:class:`~moolib_tpu_torch.fleet.rollout.Rollout`). ``wait=False``
        drives it on a background thread (the controller-kill scenario's
        shape) — the rollout record in the cohort is what a standby
        adopts and resumes. ``store`` selects the durable rollback
        source: prior params are pulled from the statestore instead of
        the in-memory registry."""
        if not self.cohort.fenced(self._epoch, self.name):
            raise AdoptError("not the fenced controller for this fleet")
        router = self.router()
        if router is None:
            raise RpcError("fleet has no live router to roll through")
        version = int(version)
        with self.cohort.lock:
            if params is not None:
                self.cohort.models[version] = params
            if version not in self.cohort.models:
                raise ValueError(f"unknown model version {version}")
            prior_v = (self.cohort.current_version
                       if prior_version is None else int(prior_version))
            prior_params = (None if store is not None
                            else self.cohort.models[prior_v])
            new_params = self.cohort.models[version]
            self.cohort.rollout = {
                "state": "idle", "version": version,
                "prior_version": prior_v,
            }
        rollout = Rollout(
            router, self.spec.rollout, fleet=self.spec.name,
            params=new_params, version=version,
            prior_params=prior_params, prior_version=prior_v,
            telemetry=self._tel, reward_fn=reward_fn,
            incident_dir=self._incident_dir, store=store,
            on_state=self._on_rollout_state, stop=self._killed,
        )
        self._rollout = rollout
        if wait:
            return rollout.run()
        self._rollout_thread = threading.Thread(
            target=rollout.run, name=f"{self.name}-rollout", daemon=True,
        )
        self._rollout_thread.start()
        return rollout

    def _on_rollout_state(self, state: str, version: int) -> None:
        with self.cohort.lock:
            if self.cohort.rollout is not None:
                self.cohort.rollout["state"] = state
            if state == "promoted":
                self.cohort.current_version = version

    # -- status / teardown ---------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The controller's observable state (also served on
        ``fleet.status``): epoch, role table, rollout record."""
        with self.cohort.lock:
            return {
                "fleet": self.spec.name,
                "controller": self.name,
                "epoch": self.cohort.epoch,
                "fenced": (self.cohort.controller == self.name
                           and self.cohort.epoch == self._epoch),
                "roles": {n: h.summary()
                          for n, h in self.cohort.roles.items()},
                "rollout": (dict(self.cohort.rollout)
                            if self.cohort.rollout else None),
                "current_version": self.cohort.current_version,
            }

    def kill(self) -> None:
        """Simulated SIGKILL: threads stop without any cleanup, the Rpc
        dies abruptly, roles are left running unsupervised — exactly the
        mess adoption must be able to inherit. ``close()`` afterwards
        only reaps the dead threads."""
        self._killed.set()
        self._stop.set()
        self.rpc.close()

    def close(self, *, close_roles: bool = False) -> None:
        """Graceful teardown of the controller's own resources (threads,
        Rpc). The cohort owns the roles: pass ``close_roles=True`` (or
        call ``cohort.close()``) from whoever owns the fleet's
        lifetime."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._killed.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=10)
        if self._watcher is not None:
            self._watcher.join(timeout=10)
        if self._rollout_thread is not None:
            self._rollout_thread.join(timeout=10)
        if close_roles:
            self.cohort.close()
        self.rpc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(close_roles=True)
