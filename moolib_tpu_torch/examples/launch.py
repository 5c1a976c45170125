"""Multi-peer launchers for the vtrace experiment; the counterpart of
:mod:`moolib_tpu.examples.launch`.

A local mode spawns a broker (``python -m moolib_tpu_torch.broker``) and
N elastic peers (``python -m moolib_tpu_torch.examples.vtrace.experiment``)
as subprocesses on this machine — the quickest way to watch elastic
membership work — and a slurm mode writes an sbatch job array where
every task joins the same broker (the reference's
examples/sbatch_experiment.py).

Everything after ``--`` reaches every peer as given: ``key=value``
config overrides and the experiment's own flags. A peer runs on the card
unless it is given ``--device cpu``; without a card and without that
flag it raises, and the launcher returns its exit code.

Usage:
    # N elastic peers on this host (starts the broker too):
    python -m moolib_tpu_torch.examples.launch local --peers 3 -- \
        --device cpu env=cartpole total_steps=100000

    # Emit an sbatch script for a cluster:
    python -m moolib_tpu_torch.examples.launch sbatch --peers 8 \
        --broker tcp://head-node:4431 --savedir /shared/run1 -- \
        env=synthetic total_steps=10000000
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

__all__ = ["launch_local", "write_sbatch"]


def _peer_cmd(broker: str, overrides, savedir=None, peer_index=0):
    cmd = [
        sys.executable, "-m", "moolib_tpu_torch.examples.vtrace.experiment",
        f"broker={broker}",
    ]
    if savedir:
        cmd.append(f"savedir={os.path.join(savedir, f'peer{peer_index}')}")
    cmd += list(overrides)
    return cmd


def launch_local(peers: int, overrides, savedir=None) -> int:
    """Broker + N experiment peers as local subprocesses; forwards SIGINT,
    returns the first nonzero peer exit code (0 if all succeed)."""
    procs = []
    broker_proc = subprocess.Popen(
        [sys.executable, "-m", "moolib_tpu_torch.broker", "127.0.0.1:0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        # The broker prints its bound address on startup.
        addr = None
        deadline = time.time() + 20
        while time.time() < deadline:
            line = broker_proc.stdout.readline()
            if not line:
                break
            sys.stdout.write("[broker] " + line)
            if "listening on" in line:
                addr = line.rsplit(" ", 1)[-1].strip()
                break
        if addr is None:
            raise RuntimeError("broker did not report a listen address")
        # Keep draining broker output: an unread 64KB pipe would eventually
        # block the broker's update loop and stall the whole group.
        import threading

        def _drain():
            for line in broker_proc.stdout:
                sys.stdout.write("[broker] " + line)

        threading.Thread(target=_drain, daemon=True).start()
        for i in range(peers):
            procs.append(
                subprocess.Popen(_peer_cmd(addr, overrides, savedir, i))
            )
        rc = 0
        for p in procs:
            rc = rc or (p.wait() or 0)
        return rc
    except KeyboardInterrupt:
        for p in procs:
            p.send_signal(signal.SIGINT)
        for p in procs:
            p.wait()
        return 130
    finally:
        broker_proc.terminate()
        broker_proc.wait()


_SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --array=0-{last}
#SBATCH --ntasks=1
#SBATCH --cpus-per-task={cpus}
#SBATCH --output={savedir}/slurm-%A_%a.out

mkdir -p {savedir}
exec {python} -m moolib_tpu_torch.examples.vtrace.experiment \\
    broker={broker} \\
    savedir={savedir}/peer$SLURM_ARRAY_TASK_ID \\
    {overrides}
"""


def write_sbatch(path, peers, broker, savedir, overrides, name="moolib-tpu",
                 cpus=10):
    """Write an sbatch array script: one elastic peer per array task
    (the reference's examples/sbatch_experiment.py)."""
    script = _SBATCH_TEMPLATE.format(
        name=name,
        last=peers - 1,
        cpus=cpus,
        savedir=savedir,
        python=sys.executable,
        broker=broker,
        overrides=" ".join(overrides),
    )
    with open(path, "w") as f:
        f.write(script)
    os.chmod(path, 0o755)
    return path


def main():
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="mode", required=True)
    pl = sub.add_parser("local", help="broker + N peers on this machine")
    pl.add_argument("--peers", type=int, default=2)
    pl.add_argument("--savedir", default=None)
    pl.add_argument("overrides", nargs="*")
    ps = sub.add_parser("sbatch", help="emit a slurm array script")
    ps.add_argument("--peers", type=int, default=2)
    ps.add_argument("--broker", required=True)
    ps.add_argument("--savedir", required=True)
    ps.add_argument("--out", default="launch.sbatch")
    ps.add_argument("--cpus", type=int, default=10)
    ps.add_argument("overrides", nargs="*")
    args = p.parse_args()
    if args.mode == "local":
        sys.exit(launch_local(args.peers, args.overrides, args.savedir))
    path = write_sbatch(
        args.out, args.peers, args.broker, args.savedir, args.overrides,
        cpus=args.cpus,
    )
    print(f"wrote {path}; submit with: sbatch {path}")


if __name__ == "__main__":
    main()
