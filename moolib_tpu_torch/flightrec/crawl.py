"""Cohort crawl: reach every peer from one address; the counterpart of
:mod:`moolib_tpu.flightrec.crawl`.

One crawl implementation for every cohort-wide scrape (metrics dumps and
incident reports must not drift: a peer reachable by one but missed by
the other would be a hole in exactly the run where it matters). The
connection table never grows
spontaneously — find-peer gossip is on demand — so the crawl seeds from
the directly-dialed peers and walks the neighbour lists each scrape
reply advertises (``__telemetry`` and ``__flightrec`` both carry
``peers``: the serving peer's dialable neighbours).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["crawl_cohort"]


def crawl_cohort(
    rpc,
    connect: Iterable[str],
    scrape: Callable[[str], Tuple[Any, Iterable[str]]],
    want: Optional[Iterable[str]] = None,
    discover_seconds: float = 2.0,
    on_result: Optional[Callable[[str, Any], None]] = None,
) -> Tuple[Dict[str, Any], List[Tuple[str, str]]]:
    """Dial ``connect`` addresses and crawl the whole connected cohort.

    ``scrape(peer)`` performs one peer's scrape and returns ``(result,
    neighbours)`` — the neighbours feed the crawl frontier (ignored when
    ``want`` pins the exact peer set). A scrape failure is recorded and
    the crawl continues: a dark peer is a finding, not a reason to lose
    everyone else's data. ``on_result`` (optional) observes each success
    in crawl order — progress printing for the CLI tools.

    Returns ``(results, failed)``: ``results`` maps peer name -> scrape
    result; ``failed`` is ``[(peer, "ExcType: message"), ...]``.
    """
    # Imported here, not at module level: the telemetry package imports
    # flightrec (the recorder rides on Telemetry), and the rpc package
    # imports telemetry — a module-level rpc import would close a cycle.
    from ..rpc import RpcError

    for addr in connect:
        rpc.connect(addr)
    # Seed with the directly-dialed peers (named once their greeting
    # lands), or the pinned set.
    deadline = time.monotonic() + discover_seconds
    seeds: set = set()
    while True:
        seeds = set(rpc.debug_info()["peers"])
        if seeds or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    want_set = set(want) if want is not None else None
    if want_set is not None:
        seeds = set(want_set)
    me = rpc.get_name()
    results: Dict[str, Any] = {}
    failed: List[Tuple[str, str]] = []
    queue = sorted(seeds)
    visited = set(queue)
    while queue:
        peer = queue.pop(0)
        try:
            result, neighbours = scrape(peer)
        except (RpcError, TimeoutError, ValueError, KeyError) as e:
            failed.append((peer, f"{type(e).__name__}: {e}"))
            continue
        results[peer] = result
        if on_result is not None:
            on_result(peer, result)
        if want_set is None:
            for nxt in neighbours:
                if nxt != me and nxt not in visited:
                    visited.add(nxt)
                    queue.append(nxt)
    return results, failed
