"""Broker: cluster membership authority.

Capability parity with the reference's Broker (reference: src/broker.h:97-265
— one broker per cluster tracks per-group peers by ping, expires silent
peers, and re-syncs groups by assigning a new syncId and pushing the sorted
member list; CLI at py/moolib/broker.py).

Protocol redesign (same guarantees, one fewer round trip): the reference runs
a 2-phase resync (sync → collect acks → update). Here the broker pushes a
single ``GroupService::update`` carrying both the new sync id and the sorted
member list; atomic epoch switching is preserved because collective ops are
keyed by sync id on every peer (see group.py), so peers in different epochs
can never complete an op together. Peers report their current sync id in each
ping, and the broker re-pushes to any peer that reports a stale one — missed
pushes heal within one ping interval.
"""

from __future__ import annotations

import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Set

from ..utils import get_logger
from .rpc import Rpc

log = get_logger("broker")

__all__ = ["Broker", "DEFAULT_PORT"]

DEFAULT_PORT = 4431  # reference default (py/moolib/broker.py)


@dataclass
class _PeerEntry:
    timeout: float
    sort_order: int
    creation_order: int
    last_ping: float = field(default_factory=time.monotonic)
    synced_id: Optional[str] = None
    push_inflight: bool = False
    last_push: float = 0.0
    # Per-process nonce from the peer's Group: a restarted process that
    # reuses its old name pings with a NEW incarnation, which must never
    # be mistaken for the dead one (its sequence/epoch state is gone).
    incarnation: Optional[str] = None


@dataclass
class _GroupEntry:
    sync_id: str
    peers: Dict[str, _PeerEntry] = field(default_factory=dict)
    needs_update: bool = False
    creation_counter: int = 0
    # Epoch adoption (standby promotion): a broker that learns of a group
    # from a ping that already CARRIES a sync id re-materializes the
    # epoch from cohort gossip instead of minting a fresh one. While
    # ``settling_until`` is in the future the roster is still forming:
    # no expiry, no minting, no pushes. At settle end, an intact roster
    # (every expected member pinged in with the adopted id) continues the
    # epoch untouched — in-flight collective ops survive the promotion.
    settling_until: Optional[float] = None
    expected_members: Optional[Set[str]] = None
    adopt_mismatch: bool = False

    def sorted_members(self):
        # Sort by (sort_order, creation_order) like the reference
        # (src/broker.h:134-190).
        return [
            name
            for name, _ in sorted(
                self.peers.items(),
                key=lambda kv: (kv[1].sort_order, kv[1].creation_order),
            )
        ]


class Broker:
    """Membership authority service bound to an Rpc instance.

    Usage (mirrors the reference CLI loop)::

        rpc = Rpc("broker"); rpc.listen(addr)
        broker = Broker(rpc)
        while True:
            broker.update(); time.sleep(0.25)
    """

    def __init__(self, rpc: Optional[Rpc] = None, name: str = "broker",
                 settle_s: float = 2.5):
        self._owns_rpc = rpc is None
        self.rpc = rpc or Rpc(name)
        self._groups: Dict[str, _GroupEntry] = {}
        # How long an adopted epoch's roster is given to re-materialize
        # from pings before this broker starts arbitrating (should cover
        # a couple of the cohort's ping intervals).
        self.settle_s = float(settle_s)
        # _ping runs on RPC executor threads while update() runs on the CLI
        # thread; one lock covers all membership state.
        self._lock = threading.Lock()
        self.rpc.define("BrokerService::ping", self._ping)

    # -- service -------------------------------------------------------------

    def _ping(self, group: str, peer_name: str, timeout: float,
              sync_id: Optional[str], sort_order: int = 0,
              incarnation: Optional[str] = None,
              members: Optional[list] = None) -> dict:
        now = time.monotonic()
        with self._lock:
            g = self._groups.get(group)
            if g is None:
                if sync_id is not None:
                    # Standby promotion: the cohort already HAS an epoch —
                    # adopt it from gossip instead of minting, and give
                    # the rest of the cohort a settle window to ping in.
                    # An intact roster then continues the epoch untouched
                    # (no resync, no cancelled in-flight ops).
                    g = self._groups[group] = _GroupEntry(
                        sync_id=sync_id,
                        settling_until=now + self.settle_s,
                        expected_members=set(members or ()),
                    )
                    log.info(
                        "group %s: re-materializing epoch %s from cohort "
                        "gossip (%d expected member(s), settling %.1fs)",
                        group, sync_id[:8], len(g.expected_members),
                        self.settle_s,
                    )
                else:
                    g = self._groups[group] = _GroupEntry(
                        sync_id=_new_sync_id()
                    )
            settling = g.settling_until is not None and now < g.settling_until
            if settling and sync_id != g.sync_id:
                # A peer on a different (or no) epoch pinged during
                # adoption: the cohort is NOT intact — resync at settle.
                g.adopt_mismatch = True
            entry = g.peers.get(peer_name)
            if (entry is not None and incarnation is not None
                    and entry.incarnation is not None
                    and entry.incarnation != incarnation):
                # Same name, new process: drop the dead incarnation's
                # entry so the restart is a fresh join (fresh epoch) —
                # never a silent continuation of stale rid/epoch state.
                del g.peers[peer_name]
                entry = None
                g.needs_update = True
                log.info("group %s: peer %s restarted (new incarnation)",
                         group, peer_name)
            if entry is None:
                entry = g.peers[peer_name] = _PeerEntry(
                    timeout=timeout,
                    sort_order=sort_order,
                    creation_order=g.creation_counter,
                    incarnation=incarnation,
                )
                g.creation_counter += 1
                if not (settling and g.expected_members
                        and peer_name in g.expected_members):
                    g.needs_update = True
                log.info("group %s: peer %s joined", group, peer_name)
            entry.last_ping = now
            entry.timeout = timeout
            entry.synced_id = sync_id
            if incarnation is not None:
                entry.incarnation = incarnation
            if entry.sort_order != sort_order:
                # Reordering is a membership-visible change: rank and tree
                # position depend on it, so push a fresh epoch (reference
                # refreshes sortOrder at each resync ACK, src/broker.h:161).
                entry.sort_order = sort_order
                g.needs_update = True
            return {"sync_id": g.sync_id}

    # -- 4Hz maintenance loop ------------------------------------------------

    def update(self):
        """Expire silent peers and push membership epochs
        (reference: BrokerService::update, src/broker.h:130-237)."""
        now = time.monotonic()
        pushes = []
        with self._lock:
            for group_name, g in self._groups.items():
                if g.settling_until is not None:
                    if now < g.settling_until:
                        # Adopted epoch still settling: the roster is
                        # incomplete, so neither expire, mint, nor push.
                        continue
                    roster = set(g.peers)
                    if g.expected_members and (
                        len(roster & g.expected_members)
                        < len(g.expected_members) // 2 + 1
                    ):
                        # FENCING: fewer than a majority of the adopted
                        # epoch's members have reached this broker. An
                        # asymmetric blip can send a lone member here
                        # while the rest of the cohort still talks to the
                        # primary — minting a minority epoch would
                        # split-brain training (two live cohorts, silent
                        # divergence). Keep settling instead: pings keep
                        # being answered with the adopted id (members
                        # keep their last sync — safe), and arbitration
                        # begins only once a majority has failed over
                        # (or restarted peers re-ping in).
                        g.settling_until = now + self.settle_s
                        log.warning(
                            "group %s: only %d/%d adopted members have "
                            "reached this broker — refusing to arbitrate "
                            "a minority epoch; still settling",
                            group_name, len(roster & g.expected_members),
                            len(g.expected_members),
                        )
                        continue
                    g.settling_until = None
                    intact = (
                        not g.adopt_mismatch
                        and g.expected_members is not None
                        and roster == g.expected_members
                        and all(e.synced_id == g.sync_id
                                for e in g.peers.values())
                    )
                    g.expected_members = None
                    if intact:
                        g.needs_update = False
                        log.info(
                            "group %s: epoch %s adopted intact "
                            "(%d members) — no resync",
                            group_name, g.sync_id[:8], len(roster),
                        )
                    else:
                        g.needs_update = True
                        log.info(
                            "group %s: roster changed across broker "
                            "promotion — resyncing", group_name,
                        )
                expired = [
                    name
                    for name, e in g.peers.items()
                    if now - e.last_ping > e.timeout
                ]
                for name in expired:
                    del g.peers[name]
                    g.needs_update = True
                    log.info("group %s: peer %s expired", group_name, name)
                if g.needs_update:
                    g.sync_id = _new_sync_id()
                    g.needs_update = False
                members = g.sorted_members()
                for name, e in g.peers.items():
                    if (
                        e.synced_id != g.sync_id
                        and not e.push_inflight
                        and now - e.last_push > 0.5
                    ):
                        e.push_inflight = True
                        e.last_push = now
                        pushes.append((group_name, g, name, members))
        for args in pushes:
            self._push_update(*args)

    def _push_update(self, group_name: str, g: _GroupEntry, peer: str, members):
        sync_id = g.sync_id

        def on_done(result, error):
            with self._lock:
                entry = g.peers.get(peer)
                if entry is not None:
                    entry.push_inflight = False
                    if error is None:
                        entry.synced_id = sync_id
            # On error the peer stays stale and is re-pushed next update()
            # (or expires) — the self-healing replacement for 2-phase acks.

        self.rpc.async_callback(
            peer, "GroupService::update", on_done, group_name, sync_id, members
        )

    def groups(self) -> dict:
        with self._lock:
            return {
                name: {"sync_id": g.sync_id, "members": g.sorted_members()}
                for name, g in self._groups.items()
            }

    def close(self):
        if self._owns_rpc:
            self.rpc.close()


def _new_sync_id() -> str:
    return secrets.token_hex(16)
