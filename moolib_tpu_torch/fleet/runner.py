"""Single-role subprocess runner: ``python -m moolib_tpu_torch.fleet.runner``;
the counterpart of :mod:`moolib_tpu.fleet.runner`.

The controller's subprocess backend
(:class:`~moolib_tpu_torch.fleet.controller.Controller` with
``backend="subprocess"``) launches one of these per role: the child
builds the role from a JSON descriptor, announces its listen address on
stdout (``FLEET_ADDR host:port`` — the parent blocks on that line), and
serves until terminated. Supervision then works exactly as in-process:
the parent probes ``fleet.ping`` over the wire, and a SIGKILLed child is
a real process death, not a simulation.

The replica role serves the canonical toy model
(:func:`~moolib_tpu_torch.fleet.controller.default_model`) — production
replicas load real weights via ``{service}.load`` / the statestore the
moment the fleet is up, so what the child boots with is a placeholder by
design. The descriptor's ``device`` names where it serves (null is the
card, which must then be present); the runner neither guesses a device
nor falls back to another.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--role", required=True,
                    help="JSON role descriptor (name, kind, fleet, "
                         "service, batch_size, max_queue, version, "
                         "device)")
    args = ap.parse_args(argv)
    desc = json.loads(args.role)
    name, kind = desc["name"], desc["kind"]

    from moolib_tpu_torch.rpc import Rpc
    from moolib_tpu_torch.rpc.broker import Broker

    device = None
    if kind == "replica":
        import torch

        from moolib_tpu_torch.utils.device import resolve_device

        if "device" not in desc:
            raise SystemExit("a replica's role descriptor must name its "
                             "device (null for the card)")
        device = resolve_device(desc["device"])
        if device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit(f"the role descriptor names {device}, and "
                             "CUDA is not available here")

    rpc = Rpc(name)
    rpc.listen("127.0.0.1:0")
    info = {"fleet": desc.get("fleet", "fleet"), "role": name,
            "kind": kind}
    rpc.define("fleet.ping", lambda: "pong")
    rpc.define("fleet.role_info", lambda: dict(info))

    obj = None
    if kind == "broker":
        obj = Broker(rpc)
    elif kind == "replica":
        from moolib_tpu_torch.fleet.controller import default_model
        from moolib_tpu_torch.serving import Replica

        model, params = default_model()
        obj = Replica(
            rpc, model, params, version=int(desc.get("version", 1)),
            service=desc.get("service", "serve"),
            batch_size=int(desc.get("batch_size", 4)),
            max_queue=int(desc.get("max_queue", 128)), device=device,
        )
    # learner/envworker: the member peer surface alone.

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    addr = rpc.debug_info()["listen"][0]
    print(f"FLEET_ADDR {addr}", flush=True)
    while not stop.is_set():
        if isinstance(obj, Broker):
            obj.update()
        time.sleep(0.05)
    if obj is not None:
        obj.close()
    rpc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
