"""Broker CLI: ``python -m moolib_tpu_torch.broker [addr]``.

The counterpart of ``python -m moolib_tpu.broker``: default port 4431, a
0.25 s update loop, and the same single address line on stdout."""

from __future__ import annotations

import argparse
import time

from .rpc import Rpc
from .rpc.broker import DEFAULT_PORT, Broker
from .utils import set_log_level, set_logging


def main(argv=None):
    parser = argparse.ArgumentParser(description="moolib_tpu_torch broker")
    parser.add_argument(
        "addr", nargs="?", default=f"0.0.0.0:{DEFAULT_PORT}",
        help="listen address (host:port or unix:path)",
    )
    parser.add_argument("--interval", type=float, default=0.25)
    args = parser.parse_args(argv)

    set_logging(True)
    set_log_level("info")
    rpc = Rpc("broker")
    rpc.listen(args.addr)
    broker = Broker(rpc)
    # Single clean address on stdout, worded as the reference's: its
    # launchers parse this line (the text after "listening on").
    print(
        f"moolib_tpu broker listening on {rpc.debug_info()['listen'][0]}",
        flush=True,
    )
    try:
        while True:
            broker.update()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        rpc.close()


if __name__ == "__main__":
    main()
