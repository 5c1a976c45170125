"""Sustained-churn soak: random SIGKILL/replace cycles against a live
elastic training cluster; the twin of the reference's
``tools/elastic_soak.py``.

N vtrace peers (``python -m moolib_tpu_torch.examples.vtrace.experiment``
on ``--device``, the card unless ``cpu`` is given) train CartPole against
one broker while a conductor SIGKILLs a random peer and boots a
replacement every ``--kill-interval`` seconds for ``--minutes``. Pass
criteria, the reference's three:

- cluster-wide progress NEVER stalls: some live peer's own ``updates``
  (its ``logs.tsv``, read with :func:`~moolib_tpu_torch.examples.plot.
  read_tsv`) advances in every ``--stall-window``-second window;
- every replacement peer reaches its first update (joins, syncs state,
  trains) before the next kill cycle ends;
- at the end, all surviving peers are still updating (no uncommanded
  death).

Writes the churn history, each replacement's seconds from spawn to its
first update (``rejoin_s``) and the progress timeline to ``--json``
(``build/elastic_soak.json`` by default); the peers' run directories go
under ``--workdir`` (a fresh directory under ``build/`` by default).

Usage::

    python -m moolib_tpu_torch.tools.elastic_soak [--minutes 5] \\
        [--peers 3] [--kill-interval 25] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_JSON = os.path.join(REPO, "build", "elastic_soak.json")


def _peer_cmd(broker_addr, savedir, device=None):
    cmd = [
        sys.executable, "-m", "moolib_tpu_torch.examples.vtrace.experiment",
        f"broker={broker_addr}",
        f"savedir={savedir}",
        "env=cartpole",
        "total_steps=100000000",
        "actor_batch_size=8",
        "learn_batch_size=8",
        "virtual_batch_size=16",
        "num_actor_processes=1",
        "unroll_length=5",
        "log_interval_steps=200",
        "stats_interval=0.5",
    ]
    if device is not None:
        cmd += ["--device", device]
    return cmd


def _spawn_peer(broker_addr, root, idx, device=None):
    savedir = os.path.join(root, f"peer{idx}")
    os.makedirs(savedir, exist_ok=True)
    # A session of its own: a kill takes the peer and its env workers.
    proc = subprocess.Popen(
        _peer_cmd(broker_addr, savedir, device), cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
        start_new_session=True,
    )
    return {"proc": proc, "savedir": savedir, "idx": idx,
            "born": time.monotonic()}


def _kill(peer):
    try:
        os.killpg(peer["proc"].pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    peer["proc"].wait()


def _updates(savedir):
    from ..examples.plot import read_tsv

    path = os.path.join(savedir, "logs.tsv")
    if not os.path.exists(path):
        return 0
    try:
        rows = read_tsv(path)
    except Exception:
        return 0
    return int(rows[-1].get("updates", 0)) if rows else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=5.0)
    ap.add_argument("--peers", type=int, default=3)
    ap.add_argument("--kill-interval", type=float, default=25.0)
    ap.add_argument("--stall-window", type=float, default=45.0)
    ap.add_argument("--startup-timeout", type=float, default=300.0,
                    help="grace for first progress before churn begins")
    ap.add_argument("--device", default=None,
                    help="the peers' torch device (default: the card)")
    ap.add_argument("--json", default=DEFAULT_JSON)
    ap.add_argument("--workdir", default=None,
                    help="where the peers' run directories go")
    args = ap.parse_args(argv)

    # Imported here: the peers' EnvPools never import this module, but a
    # tool's top level stays free of torch (the package's tools import
    # their stacks inside main).
    from .. import set_log_level
    from ..examples.common import InProcessBroker

    set_log_level("error")
    broker = InProcessBroker()
    if args.workdir is None:
        os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
        root = tempfile.mkdtemp(prefix="soak_",
                                dir=os.path.join(REPO, "build"))
    else:
        root = args.workdir
        os.makedirs(root, exist_ok=True)
    rng = random.Random(0)

    peers = [_spawn_peer(broker.address, root, i, args.device)
             for i in range(args.peers)]
    next_idx = args.peers
    history = []
    rejoin = {}
    timeline = []
    best_seen = 0
    ok, fail_reason = True, None
    t0 = time.monotonic()

    # SIGTERM (a harness ending the soak early) runs the finally below:
    # the peers sit in sessions of their own, which no group kill of
    # this process reaches.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        # Churn a RUNNING cluster: wait for first progress before the clock
        # and the kill cycles start (killing mid-start-up only measures the
        # host, not elasticity).
        startup_deadline = t0 + args.startup_timeout
        while time.monotonic() < startup_deadline:
            best_seen = max(
                (_updates(p["savedir"]) for p in peers), default=0
            )
            if best_seen > 0:
                break
            time.sleep(2.0)
        if best_seen == 0:
            ok, fail_reason = False, (
                f"cluster never produced an update within "
                f"{args.startup_timeout}s of startup"
            )
        startup_s = round(time.monotonic() - t0, 1)

        t_end = time.monotonic() + args.minutes * 60
        last_kill = time.monotonic()
        last_advance = time.monotonic()
        while ok and time.monotonic() < t_end:
            time.sleep(2.0)
            now = time.monotonic()
            # Progress = any live peer's OWN update counter advancing
            # (replacement peers restart their counters at zero, so a
            # cluster-max metric would freeze whenever the most-advanced
            # peer is the one killed).
            advanced = False
            total_now = 0
            for p in peers:
                u = _updates(p["savedir"])
                total_now += u
                if u > p.get("last_updates", 0):
                    p["last_updates"] = u
                    advanced = True
                    if p["idx"] >= args.peers and p["idx"] not in rejoin:
                        rejoin[p["idx"]] = round(now - p["born"], 1)
            best_seen = max(best_seen, total_now)
            timeline.append(
                {"t": round(now - t0, 1), "live_updates_sum": total_now,
                 "alive": sum(p["proc"].poll() is None for p in peers)}
            )
            if advanced:
                last_advance = now
            elif now - last_advance > args.stall_window:
                ok, fail_reason = False, (
                    f"no progress for {args.stall_window}s at "
                    f"updates={best_seen}"
                )
                break
            # Unexpected deaths (not ours) fail the soak.
            for p in peers:
                rc = p["proc"].poll()
                if rc is not None and not p.get("killed"):
                    ok, fail_reason = False, (
                        f"peer{p['idx']} died uncommanded (rc={rc})"
                    )
                    break
            if not ok:
                break
            if now - last_kill >= args.kill_interval:
                last_kill = now
                victim = rng.choice(peers)
                victim["killed"] = True
                _kill(victim)
                peers.remove(victim)
                repl = _spawn_peer(broker.address, root, next_idx,
                                   args.device)
                peers.append(repl)
                history.append(
                    {"t": round(now - t0, 1),
                     "killed": victim["idx"], "spawned": next_idx,
                     "victim_updates": victim.get("last_updates", 0)}
                )
                print(json.dumps(history[-1]), flush=True)
                next_idx += 1
    finally:
        for p in peers:
            _kill(p)
        broker.close()

    # Every replacement must have reached its first update, except ones
    # born within the last kill cycle (not enough time to start and join).
    late_born = time.monotonic() - args.kill_interval - 30
    stragglers = [
        p["idx"] for p in peers
        if p["born"] < late_born and _updates(p["savedir"]) == 0
    ]
    if ok and stragglers:
        ok, fail_reason = False, f"replacements never trained: {stragglers}"

    cmd = (f"python -m moolib_tpu_torch.tools.elastic_soak "
           f"--minutes {args.minutes} --peers {args.peers} "
           f"--kill-interval {args.kill_interval}")
    if args.device is not None:
        cmd += f" --device {args.device}"
    art = {
        "round": 4,
        "cmd": cmd,
        "ok": ok,
        "fail_reason": fail_reason,
        "kills": len(history),
        "peak_live_updates_sum": best_seen,
        "startup_s": startup_s,
        "rejoin_s": {str(k): v for k, v in sorted(rejoin.items())},
        "churn_history": history,
        "progress_timeline": timeline[-30:],
        "note": (
            "sustained random SIGKILL/replace churn against a live elastic "
            "cluster; pass = cluster-wide updates never stall a full "
            "window, no uncommanded deaths, replacements train"
        ),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps({"ok": ok, "kills": len(history),
                      "peak_live_updates_sum": best_seen,
                      "rejoin_s": art["rejoin_s"],
                      "fail_reason": fail_reason}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
