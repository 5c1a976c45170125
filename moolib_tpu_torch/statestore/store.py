"""StateStore: peer-replicated, integrity-verified durable training
state; the counterpart of :mod:`moolib_tpu.statestore.store`, on the
port's ``Rpc`` and wire-compatible with the reference's (a cohort may
mix stores of both packages).

The durability counterpart of the Accumulator's "no single point of
authority": a cohort survives crashes and broker loss, but a restart
that hangs on a single local checkpoint file does not survive the loss
of its host (or a disk that fills mid-write). Here every member runs a
:class:`StateStore`; the leader's
:class:`Replicator` streams each committed model version as a
content-hashed chunked bundle (:mod:`moolib_tpu_torch.statestore.bundle`) to
K follower replicas over the existing RPC lanes — asynchronously, off
the training thread, so gradient rounds never stall on disk or DCN —
and every member serves the ``StateStoreService`` fetch family so a
rejoiner whose disk was wiped can pull state from any surviving
replica.

Restore negotiation (cohort restart): members exchange
``(version, manifest_hash)`` advertisements (only locally *verified*
versions are advertised), agree on the newest version whose manifest
hash matches on a quorum of holders, and the puller fetches chunks from
the holders with per-chunk sha256 verification — a hash-rejected chunk
is refetched from a different holder, so one bit-flipped replica costs
a refetch, not the restore.

Failure semantics (the resource-exhaustion contract): a failed local write is a *typed*
(:class:`~moolib_tpu_torch.statestore.bundle.WriteFailed`), counted
(``statestore_write_failures_total``), flight-recorded event that marks
the store degraded — publish keeps going and pushes the bundle to the
replicas (one extra follower while degraded, so the durability role
moves to a healthy host), and crash-atomic staging guarantees no torn
or half-GC'd bundle ever becomes visible.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from ..rpc.rpc import Rpc, RpcError
from ..telemetry import Telemetry, global_telemetry
from ..utils import get_logger
from .bundle import (
    CHUNK_BYTES_DEFAULT,
    BundleCorrupt,
    StateStoreError,
    WriteFailed,
    chunk_blob,
    decode_state,
    encode_state,
    list_versions,
    manifest_for,
    manifest_hash,
    read_chunk,
    read_manifest,
    remove_version,
    sha256_hex,
    sweep,
    validate_manifest,
    verify_version,
    write_version,
)

log = get_logger("statestore")

__all__ = ["Negotiated", "Replicator", "StateStore"]

#: How long a wire-offered manifest may sit in the ingest staging area
#: waiting for its chunks before a later offer sweeps it (a publisher
#: that died mid-push must not leak model-sized staging buffers).
_STAGING_TTL_S = 120.0

LOCAL = "<local>"


class Negotiated(NamedTuple):
    """Outcome of a restore negotiation: the agreed version, its
    manifest (validated, hash-checked), and the holders that advertised
    the winning ``(version, manifest_hash)`` pair (``LOCAL`` for this
    store's own disk)."""

    version: int
    manifest: Dict[str, Any]
    manifest_hash: str
    holders: List[str]


class StateStore:
    """Local versioned bundle store + the ``StateStoreService`` wire
    family + replication push/pull.

    With ``rpc`` given, registers ``StateStoreService::versions /
    ::manifest / ::chunk`` (the fetch family every member serves) and
    ``::offer / ::ingest / ::commit`` (the push-replication family).
    Versions are immutable once committed; GC keeps ``keep_versions``
    newest bundles and additionally evicts oldest-first while the store
    exceeds ``disk_budget_bytes`` (the newest version is never evicted).
    """

    SERVICE = "StateStoreService"

    def __init__(self, root: str, rpc: Optional[Rpc] = None, *,
                 chunk_bytes: int = CHUNK_BYTES_DEFAULT,
                 keep_versions: int = 3,
                 disk_budget_bytes: Optional[int] = None,
                 telemetry: Optional[Telemetry] = None,
                 name: Optional[str] = None):
        if keep_versions < 1:
            raise ValueError("keep_versions must be >= 1")
        self.root = root
        self.rpc = rpc
        self._chunk_bytes = int(chunk_bytes)
        self._keep = int(keep_versions)
        self._budget = disk_budget_bytes
        self.name = name or (rpc.get_name() if rpc is not None
                             else "statestore")
        sweep(root)

        self._lock = threading.Lock()
        self._closed = False
        self._degraded = False
        #: version -> manifest_hash for versions this process has FULLY
        #: verified (manifest schema + every chunk hash). versions()
        #: advertises from this cache, so verification is paid once —
        #: and a replica whose disk rots AFTER verification is exactly
        #: the corrupt-holder case restore negotiation must survive.
        self._verified: Dict[int, str] = {}
        #: wire-ingest staging: version -> {"m", "h", "chunks", "t"}.
        self._staging: Dict[int, Dict[str, Any]] = {}
        self._disk_bytes = 0

        tel = telemetry
        if tel is None:
            tel = rpc.telemetry if rpc is not None else global_telemetry()
        self._tel = tel
        self._flight = tel.flight
        reg = tel.registry
        self._m_puts = reg.counter("statestore_put_total")
        self._m_put_s = reg.histogram("statestore_put_seconds")
        self._m_write_failures: Dict[str, Any] = {}
        self._m_gc = reg.counter("statestore_gc_versions_total")
        self._m_repl = reg.counter("statestore_replicate_total")
        self._m_repl_fail = reg.counter("statestore_replicate_failures_total")
        self._m_repl_bytes = reg.counter("statestore_replicate_bytes_total")
        self._m_repl_s = reg.histogram("statestore_replicate_seconds")
        self._m_ingest_chunks = reg.counter("statestore_ingest_chunks_total")
        self._m_ingest_commits = reg.counter(
            "statestore_ingest_commits_total"
        )
        self._m_restores = reg.counter("statestore_restore_total")
        self._m_restore_fail = reg.counter(
            "statestore_restore_failures_total"
        )
        self._m_restore_s = reg.histogram("statestore_restore_seconds")
        self._m_rejects = reg.counter("statestore_chunk_rejects_total")
        # Weakref gauges, store-labelled (two stores sharing one
        # Telemetry must not replace or cross-unregister each other's
        # series — the PR-5 rpc-gauge rule); close() unregisters.
        self._gauge_labels = {"store": self.name}
        wself = weakref.ref(self)
        reg.gauge_fn("statestore_versions",
                     lambda: len(list_versions(wself().root)),
                     **self._gauge_labels)
        reg.gauge_fn("statestore_disk_bytes",
                     lambda: wself()._disk_bytes, **self._gauge_labels)
        reg.gauge_fn("statestore_degraded",
                     lambda: 1.0 if wself()._degraded else 0.0,
                     **self._gauge_labels)
        self._recount_disk()

        if rpc is not None:
            svc = self.SERVICE
            if rpc.defined(f"{svc}::versions"):
                # Same-fid clobbering: a second store on one Rpc would
                # silently steal the first one's fetch family.
                raise RuntimeError(
                    "a StateStore is already registered on this Rpc; "
                    "one Rpc peer hosts at most one StateStore"
                )
            rpc.define(f"{svc}::versions", self._serve_versions)
            rpc.define(f"{svc}::manifest", self._serve_manifest)
            rpc.define(f"{svc}::chunk", self._serve_chunk)
            rpc.define(f"{svc}::offer", self._serve_offer)
            rpc.define(f"{svc}::ingest", self._serve_ingest)
            rpc.define(f"{svc}::commit", self._serve_commit)

    # -- local store ---------------------------------------------------------

    @property
    def degraded(self) -> bool:
        """True after a local write failure, until a later local write
        succeeds. A degraded store still SERVES everything it verifiably
        holds and still replicates — only its own disk is suspect."""
        with self._lock:
            return self._degraded

    def versions(self) -> List[Tuple[int, str]]:
        """Verified-on-this-process ``(version, manifest_hash)`` pairs,
        ascending — the advertisement restore negotiation exchanges. A
        version that fails verification is never advertised."""
        out = []
        for v in list_versions(self.root):
            h = self._verified_hash(v)
            if h is not None:
                out.append((v, h))
        return out

    def latest(self) -> Optional[int]:
        vs = self.versions()
        return vs[-1][0] if vs else None

    def put(self, version: int, state: Any,
            meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Crash-atomically persist ``state`` as ``version`` locally.
        Raises :class:`WriteFailed` (typed, counted, flight-recorded,
        store marked degraded) on any local durability failure."""
        blob = encode_state(state)
        chunks = chunk_blob(blob, self._chunk_bytes)
        manifest = manifest_for(version, chunks, meta)
        self._put_chunks(version, manifest, chunks)
        return manifest

    def _put_chunks(self, version: int, manifest: Dict[str, Any],
                    chunks: List[bytes]) -> None:
        t0 = time.monotonic()
        try:
            write_version(self.root, version, manifest, chunks)
        except FileExistsError:  # moolint: disable=counter-restore-parity
            # Immutable: an identical commit already landed. Nothing was
            # written, so the degraded flag is deliberately untouched —
            # a no-op cannot be evidence the disk healed (or broke).
            return
        except OSError as e:
            self._note_write_failure(version, e)
            raise WriteFailed(
                f"persisting version {version} failed: "
                f"{type(e).__name__}: {e}"
            ) from e
        with self._lock:
            self._degraded = False
            self._verified[version] = manifest_hash(manifest)
        self._m_puts.inc()
        self._m_put_s.observe(time.monotonic() - t0)
        self._recount_disk()
        self._gc()

    def load(self, version: int) -> Any:
        """Verify + decode a locally held version (raises
        :class:`BundleCorrupt` / ``FileNotFoundError``)."""
        m = verify_version(self.root, version)
        blob = b"".join(
            read_chunk(self.root, version, c["i"]) for c in m["chunks"]
        )
        return decode_state(blob)

    def verify_all(self) -> List[int]:
        """Strictly re-verify EVERY committed version (cache bypassed) —
        the post-fault audit the disk-full scenario runs: whatever
        survived an injected ENOSPC must verify completely or not exist.
        Returns the verified versions; raises on the first corrupt one."""
        out = []
        for v in list_versions(self.root):
            m = verify_version(self.root, v)
            with self._lock:
                self._verified[v] = manifest_hash(m)
            out.append(v)
        return out

    def _verified_hash(self, version: int) -> Optional[str]:
        with self._lock:
            h = self._verified.get(version)
        if h is not None:
            return h
        try:
            m = verify_version(self.root, version)
        except FileNotFoundError:
            return None  # we simply don't hold it (normal for an offer)
        except BundleCorrupt as e:
            log.warning("%s: version %d fails verification (%s) — "
                        "not advertising it", self.name, version, e)
            return None
        h = manifest_hash(m)
        with self._lock:
            self._verified[version] = h
        return h

    def _note_write_failure(self, version: int, e: OSError) -> None:
        op = getattr(e, "statestore_op", None) or "write"
        c = self._m_write_failures.get(op)
        if c is None:
            c = self._tel.registry.counter(
                "statestore_write_failures_total", op=op
            )
            self._m_write_failures[op] = c
        c.inc()
        with self._lock:
            self._degraded = True
        if self._flight.on:
            self._flight.record(
                "ss_write_failure", store=self.name, version=int(version),
                op=op, error=f"{type(e).__name__}: {e}"[:200],
            )
        log.error("%s: local write of version %d failed (%s) — store "
                  "degraded; replicas carry durability", self.name,
                  version, e)

    def _recount_disk(self) -> None:
        total = 0
        for v in list_versions(self.root):
            try:
                total += read_manifest(self.root, v)["total_bytes"]
            except (BundleCorrupt, FileNotFoundError, OSError):
                continue
        self._disk_bytes = total

    def _gc(self) -> None:
        """Evict oldest versions beyond ``keep_versions`` / the disk
        budget. Crash-atomic per version (rename-then-delete); the
        newest version is never evicted."""
        vs = list_versions(self.root)
        while len(vs) > 1 and (
            len(vs) > self._keep
            or (self._budget is not None and self._disk_bytes > self._budget)
        ):
            victim = vs.pop(0)
            if remove_version(self.root, victim):
                self._m_gc.inc()
                with self._lock:
                    self._verified.pop(victim, None)
                if self._flight.on:
                    self._flight.record("ss_gc", store=self.name,
                                        version=int(victim))
            self._recount_disk()

    # -- publish + push replication (the leader side) ------------------------

    def publish(self, version: int, state: Any, peers: Tuple[str, ...] = (),
                *, meta: Optional[Dict[str, Any]] = None, window: int = 4,
                timeout: float = 30.0) -> Dict[str, bool]:
        """Bundle ``state`` once, persist locally, and push the bundle to
        ``peers``. Local write failure is typed+counted+degrading but
        does NOT abort the publish — the replicas are the durability
        then. Returns ``{LOCAL: bool, peer: bool, ...}`` acks."""
        blob = encode_state(state)
        chunks = chunk_blob(blob, self._chunk_bytes)
        manifest = manifest_for(version, chunks, meta)
        acks: Dict[str, bool] = {}
        try:
            self._put_chunks(version, manifest, chunks)
            acks[LOCAL] = True
        except WriteFailed:
            acks[LOCAL] = False  # counted + recorded in _note_write_failure
        for peer in peers:
            acks[peer] = self._replicate_to(peer, version, manifest,
                                            chunks, window=window,
                                            timeout=timeout)
        if self._flight.on:
            self._flight.record(
                "ss_publish", store=self.name, version=int(version),
                chunks=len(chunks), bytes=len(blob),
            )
        return acks

    def replicate(self, version: int, peers: Tuple[str, ...], *,
                  window: int = 4, timeout: float = 30.0
                  ) -> Dict[str, bool]:
        """Push an already-committed local version to ``peers``."""
        m = verify_version(self.root, version)
        chunks = [read_chunk(self.root, version, c["i"])
                  for c in m["chunks"]]
        return {
            peer: self._replicate_to(peer, version, m, chunks,
                                     window=window, timeout=timeout)
            for peer in peers
        }

    def _replicate_to(self, peer: str, version: int,
                      manifest: Dict[str, Any], chunks: List[bytes], *,
                      window: int, timeout: float) -> bool:
        if self.rpc is None:
            raise StateStoreError("replication needs an Rpc-backed store")
        svc = self.SERVICE
        t0 = time.monotonic()
        ok = False
        try:
            want = self.rpc.async_(
                peer, f"{svc}::offer", manifest
            ).result(timeout=timeout)
            if want is False:
                ok = True  # peer already holds this exact version
            else:
                calls = [
                    (peer, f"{svc}::ingest", (version, i, c))
                    for i, c in enumerate(chunks)
                ]
                results = self.rpc.bulk(calls, window=window,
                                        timeout=timeout)
                err = next((e for _r, e in results if e is not None), None)
                if err is not None:
                    raise err
                committed = self.rpc.async_(
                    peer, f"{svc}::commit", version
                ).result(timeout=timeout)
                ok = bool(committed)
                if ok:
                    self._m_repl_bytes.inc(sum(len(c) for c in chunks))
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except (RpcError, TimeoutError) as e:
            log.warning("%s: replication of v%d to %s failed: %s",
                        self.name, version, peer, e)
        if ok:
            self._m_repl.inc()
        else:
            self._m_repl_fail.inc()
        self._m_repl_s.observe(time.monotonic() - t0)
        if self._flight.on:
            self._flight.record("ss_replicate", store=self.name,
                                version=int(version), peer=peer, ok=ok)
        return ok

    # -- wire service (every member serves these) ----------------------------

    def _serve_versions(self):
        return [[v, h] for v, h in self.versions()]

    def _serve_manifest(self, version):
        # Deliberately re-read from disk (NOT the verified cache): the
        # negotiation's corrupt-manifest defense depends on the fetched
        # manifest being what the disk holds NOW.
        return read_manifest(self.root, int(version))

    def _serve_chunk(self, version, i):
        return read_chunk(self.root, int(version), int(i))

    def _serve_offer(self, manifest):
        m = validate_manifest(manifest)
        v = m["version"]
        h = manifest_hash(m)
        if self._verified_hash(v) == h:
            return False  # already durable here
        now = time.monotonic()
        with self._lock:
            if self._closed:
                raise StateStoreError("store is closed")
            for stale in [sv for sv, e in self._staging.items()
                          if now - e["t"] > _STAGING_TTL_S]:
                del self._staging[stale]
            self._staging[v] = {"m": m, "h": h, "chunks": {}, "t": now}
        return True

    def _serve_ingest(self, version, i, data):
        v, i = int(version), int(i)
        data = bytes(data)
        with self._lock:
            entry = self._staging.get(v)
        if entry is None:
            raise StateStoreError(f"no staged offer for version {v}")
        spec = entry["m"]["chunks"]
        if not 0 <= i < len(spec):
            raise StateStoreError(f"chunk index {i} out of range")
        want = spec[i]
        if len(data) != want["size"] or sha256_hex(data) != want["sha256"]:
            # Reject AT INGEST: a corrupt chunk never enters staging, so
            # commit can only ever write verified bytes.
            raise BundleCorrupt(
                f"ingested chunk {i} of v{v} fails verification"
            )
        with self._lock:
            entry["chunks"][i] = data
            entry["t"] = time.monotonic()
        self._m_ingest_chunks.inc()
        return True

    def _serve_commit(self, version):
        v = int(version)
        with self._lock:
            entry = self._staging.get(v)
        if entry is None:
            raise StateStoreError(f"no staged offer for version {v}")
        m = entry["m"]
        if len(entry["chunks"]) != len(m["chunks"]):
            raise StateStoreError(
                f"commit of v{v} with "
                f"{len(m['chunks']) - len(entry['chunks'])} chunk(s) "
                "missing"
            )
        chunks = [entry["chunks"][i] for i in range(len(m["chunks"]))]
        try:
            self._put_chunks(v, m, chunks)
        except WriteFailed:
            return False  # typed + counted + degraded; publisher sees False
        finally:
            with self._lock:
                self._staging.pop(v, None)
        self._m_ingest_commits.inc()
        return True

    # -- restore negotiation + pull (the rejoiner side) ----------------------

    def negotiate(self, peers: Tuple[str, ...], *, quorum: int = 1,
                  timeout: float = 10.0) -> Optional[Negotiated]:
        """Run the restore negotiation: collect ``(version, hash)``
        advertisements from ``peers`` and this store's own disk, then
        pick the newest version whose manifest hash agrees on at least
        ``quorum`` holders AND whose manifest actually fetches and
        verifies from one of them. Divergent hashes for one version
        split the holder count (majority hash wins; a minority/corrupt
        holder is simply not in the winning set); a candidate whose
        every holder serves a mismatching manifest is dropped and the
        next-newest version is tried. Returns None when nothing
        restorable exists anywhere."""
        if quorum < 1:
            raise ValueError("quorum must be >= 1")
        ads: Dict[int, Dict[str, List[str]]] = {}

        def add(holder: str, pairs) -> None:
            for v, h in pairs:
                ads.setdefault(int(v), {}).setdefault(str(h), []).append(
                    holder
                )

        add(LOCAL, self.versions())
        if peers and self.rpc is None:
            raise StateStoreError("peer negotiation needs an Rpc-backed "
                                  "store")
        futs = {
            peer: self.rpc.async_(peer, f"{self.SERVICE}::versions")
            for peer in peers
        }
        for peer, fut in futs.items():
            try:
                add(peer, fut.result(timeout=timeout))
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # never swallow task cancellation
            except (RpcError, TimeoutError) as e:
                log.warning("%s: negotiation: no advertisement from %s "
                            "(%s)", self.name, peer, e)
        for v in sorted(ads, reverse=True):
            by_hash = ads[v]
            # Majority hash wins; ties break to the lexicographically
            # smallest hash so every member negotiating the same
            # advertisements picks the same candidate.
            best = sorted(by_hash, key=lambda h: (-len(by_hash[h]), h))[0]
            holders = by_hash[best]
            if len(holders) < quorum:
                continue
            for holder in holders:
                try:
                    m = (read_manifest(self.root, v) if holder == LOCAL
                         else validate_manifest(self.rpc.async_(
                             holder, f"{self.SERVICE}::manifest", v
                         ).result(timeout=timeout)))
                except (asyncio.CancelledError,
                        concurrent.futures.CancelledError):
                    raise  # never swallow task cancellation
                except (StateStoreError, RpcError, TimeoutError,
                        FileNotFoundError) as e:
                    log.warning("%s: negotiation: manifest of v%d from "
                                "%s rejected: %s", self.name, v, holder, e)
                    continue
                if manifest_hash(m) == best and m["version"] == v:
                    return Negotiated(v, m, best, list(holders))
                log.warning(
                    "%s: negotiation: %s serves a manifest for v%d that "
                    "does not match its advertisement", self.name, holder, v,
                )
            # every holder of the winning hash failed to substantiate it
        return None

    def restore(self, peers: Tuple[str, ...], *, quorum: int = 1,
                window: int = 8, timeout: float = 30.0
                ) -> Optional[Tuple[int, Any]]:
        """Negotiate + pull: returns ``(version, state)`` of the newest
        quorum-agreed version, pulling chunks from any holder with
        per-chunk verification (hash-rejected chunks are refetched from
        a different holder). The pulled bundle is re-persisted locally
        best-effort, so the rejoiner immediately becomes a holder again.
        Returns None when nothing restorable exists; raises
        :class:`StateStoreError` when a negotiated version cannot be
        completed from any holder."""
        t0 = time.monotonic()
        neg = self.negotiate(peers, quorum=quorum, timeout=timeout)
        if neg is None:
            return None
        v, m = neg.version, neg.manifest
        n = len(m["chunks"])
        chunks: List[Optional[bytes]] = [None] * n
        refetched = 0
        if LOCAL in neg.holders:
            try:
                state = self.load(v)
                self._m_restores.inc()
                self._m_restore_s.observe(time.monotonic() - t0)
                self._record_restore(v, neg, refetched=0)
                return v, state
            except (BundleCorrupt, FileNotFoundError, OSError) as e:
                log.warning("%s: local copy of v%d unusable (%s); "
                            "pulling from peers", self.name, v, e)
                # Repair path: drop the corrupt local copy so the pulled
                # bundle can be re-persisted under the same version.
                remove_version(self.root, v)
                with self._lock:
                    self._verified.pop(v, None)
        holders = [h for h in neg.holders if h != LOCAL]
        if not holders:
            self._m_restore_fail.inc()
            raise StateStoreError(
                f"negotiated v{v} but no remote holder and the local "
                "copy is unusable"
            )
        remaining = list(range(n))
        for attempt in range(len(holders)):
            calls = [
                (holders[(i + attempt) % len(holders)],
                 f"{self.SERVICE}::chunk", (v, i))
                for i in remaining
            ]
            results = self.rpc.bulk(calls, window=window, timeout=timeout)
            still = []
            for (holder, _ep, _args), i, (res, err) in zip(
                calls, remaining, results
            ):
                spec = m["chunks"][i]
                if err is None and isinstance(res, (bytes, bytearray,
                                                    memoryview)):
                    data = bytes(res)
                    if (len(data) == spec["size"]
                            and sha256_hex(data) == spec["sha256"]):
                        chunks[i] = data
                        continue
                    # Integrity failure: this holder's copy of THIS
                    # chunk is bad — count, and refetch elsewhere.
                    self._m_rejects.inc()
                log.warning(
                    "%s: chunk %d of v%d from %s rejected (%s); "
                    "refetching from another holder", self.name, i, v,
                    holder, err if err is not None else "hash mismatch",
                )
                refetched += 1
                still.append(i)
            remaining = still
            if not remaining:
                break
        if remaining:
            self._m_restore_fail.inc()
            raise StateStoreError(
                f"restore of v{v}: chunk(s) {remaining} unavailable from "
                f"any of {holders}"
            )
        blob = b"".join(chunks)  # type: ignore[arg-type]
        state = decode_state(blob)
        try:
            self._put_chunks(v, m, [bytes(c) for c in chunks
                                    if c is not None])
        except WriteFailed:
            pass  # counted + degraded; the restored STATE is still good
        self._m_restores.inc()
        self._m_restore_s.observe(time.monotonic() - t0)
        self._record_restore(v, neg, refetched=refetched)
        return v, state

    def _record_restore(self, version: int, neg: Negotiated,
                        refetched: int) -> None:
        if self._flight.on:
            self._flight.record(
                "ss_restore", store=self.name, version=int(version),
                holders=list(neg.holders), refetched=int(refetched),
            )

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._staging.clear()
        reg = self._tel.registry
        for g in ("statestore_versions", "statestore_disk_bytes",
                  "statestore_degraded"):
            reg.unregister(g, **self._gauge_labels)
        if self.rpc is not None:
            for ep in ("versions", "manifest", "chunk", "offer", "ingest",
                       "commit"):
                self.rpc.undefine(f"{self.SERVICE}::{ep}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _replicator_entry(ref: "weakref.ref[Replicator]") -> None:
    """Module-level thread target holding only a weakref between ticks
    (a bound-method target pins an abandoned owner forever — no close(),
    no GC, leaked thread)."""
    while True:
        self = ref()
        if self is None or self._stop.is_set():
            return
        wake = self._wake
        del self  # do not pin across the wait
        wake.wait(0.2)
        self = ref()
        if self is None or self._stop.is_set():
            return
        try:
            self._tick()
        except (asyncio.CancelledError, concurrent.futures.CancelledError):
            raise  # never swallow task cancellation
        except Exception as e:  # the loop must survive any one publish
            log.error("replicator tick failed: %s", e)
        del self


class Replicator:
    """Streams each committed model version to the store + K follower
    replicas, asynchronously.

    Attaches to an :class:`~moolib_tpu_torch.parallel.Accumulator` via its
    durability hook: every version the training loop applies (at
    ``zero_gradients`` time, when the local params embody it) is noted;
    a worker thread — never the training thread — snapshots the state
    (``state_fn``), bundles it, persists locally and pushes to the K
    members after this one in the roster (one extra while the local
    store is degraded, so a full disk hands the durability role to a
    healthy host). Latest-wins: if training outpaces replication,
    intermediate versions are skipped — durability wants the newest
    state, not every state.

    Only the cohort LEADER publishes (followers hold replicas; a
    follower publishing too would just duplicate bytes on the wire).

    ``state_fn`` runs on the replicator's thread. For a learner on the
    card it is :func:`~moolib_tpu_torch.learner.train_state_to_host`
    under the lock that orders it against the apply step (the copy off
    the card waits for the card, so it must not overlap anything that
    forbids such waits, e.g. CUDA's sync debug mode set by the training
    thread).
    """

    #: Publish-outcome entries retained (far beyond any store's
    #: keep_versions; the dedupe only ever consults the newest).
    _PUBLISHED_KEEP = 256

    def __init__(self, store: StateStore, accumulator, state_fn: Callable[[],
                 Any], *, followers: int = 2,
                 peers_fn: Optional[Callable[[], List[str]]] = None,
                 window: int = 4, timeout: float = 30.0):
        if followers < 0:
            raise ValueError("followers must be >= 0")
        self.store = store
        self.acc = accumulator
        self._state_fn = state_fn
        self._followers = int(followers)
        self._peers_fn = peers_fn
        self._window = int(window)
        self._timeout = float(timeout)
        self._lock = threading.Lock()
        self._pending: Optional[int] = None
        #: Recent publish outcomes, version -> acks. Bounded (newest
        #: ``_PUBLISHED_KEEP``): it exists for latest-version dedupe and
        #: post-hoc audits, not as an unbounded run history — a
        #: days-long run must not grow one dict entry per model version.
        self.published: Dict[int, Dict[str, bool]] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._replicator_closed = False
        accumulator.set_durability_hook(self._on_version)
        self._thread = threading.Thread(
            target=_replicator_entry, args=(weakref.ref(self),),
            name=f"{store.name}-replicator", daemon=True,
        )
        self._thread.start()

    def _on_version(self, version: int) -> None:
        with self._lock:
            self._pending = int(version)  # latest-wins dirty mark
        self._wake.set()

    def _tick(self) -> None:
        with self._lock:
            pending = self._pending
            self._pending = None
            self._wake.clear()
        if pending is None or not self.acc.is_leader():
            return
        # Publish the CURRENT stable version, not the (possibly stale)
        # hook-time one: under fast training the hook's version is
        # already old by the time this thread runs, and insisting on it
        # would starve durability forever. A version is stable exactly
        # when no reduced result is queued-unapplied (then the params
        # embody result_model_version) and it did not advance across
        # the snapshot; a lost race retries within the tick, then
        # re-arms the wake so the next tick tries again.
        for _ in range(4):
            v0 = int(self.acc.result_model_version())
            if self.acc.has_gradients():
                time.sleep(0.001)  # a result is mid-apply; let it land
                continue
            with self._lock:
                if v0 in self.published:
                    return
            state = self._state_fn()
            if (self.acc.result_model_version() == v0
                    and not self.acc.has_gradients()):
                acks = self.store.publish(
                    v0, state, tuple(self._peers()), window=self._window,
                    timeout=self._timeout,
                )
                with self._lock:
                    self.published[v0] = acks
                    while len(self.published) > self._PUBLISHED_KEEP:
                        self.published.pop(next(iter(self.published)))
                return
        with self._lock:  # lost every race: stay dirty for the next tick
            if self._pending is None:
                self._pending = pending
        self._wake.set()

    def _peers(self) -> List[str]:
        if self._peers_fn is not None:
            return list(self._peers_fn())
        # Deterministic placement: the K members after me in SORTED ring
        # order. group.members reflects join/gossip order, which varies
        # run to run — durability placement must not (every member, and
        # every restart, must agree on who holds the replicas).
        me = self.acc.rpc.get_name()
        members = sorted(self.acc.group.members)
        if me in members:
            i = members.index(me)
            ring = members[i + 1:] + members[:i]
        else:
            ring = [m for m in members if m != me]
        k = self._followers + (1 if self.store.degraded else 0)
        return ring[:k]

    def close(self) -> None:
        if self._replicator_closed:
            return
        self._replicator_closed = True
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)
        self.acc.set_durability_hook(None)
