"""Fault-injection hook contract for the RPC wire seams; the counterpart
of :mod:`moolib_tpu.rpc.faults`.

This module defines the *contract* only — the seam vocabulary an
:class:`~moolib_tpu_torch.rpc.rpc.Rpc` consults when a hooks object is
installed via ``Rpc.install_fault_hooks``. The deterministic scenario
engine that implements it is :mod:`moolib_tpu_torch.testing.chaos`
(``FaultPlan`` and ``ChaosNet``); any object with these methods serves.

Seams (all on the Rpc's IO loop thread):

- **send** — every outgoing frame list, whether it flows through the
  synchronous fast path (``_write_now``) or the awaitable path
  (``_write``). The verdict is applied *before* bytes reach the
  transport, so a DROP is indistinguishable from network loss: the
  sender's bookkeeping (``last_send``, in-flight tracking, pokes)
  proceeds exactly as if the message had been sent.
- **recv** — every decoded inbound message, after frame reassembly and
  before ``_dispatch`` routing. A DROP here is indistinguishable from
  loss on the receiver's NIC; a DUP models duplicate delivery of the
  same ``rid`` (the reliability layer's duplicate-suppression seam).
- **conn drop** — observation-only notification when a connection dies
  (injected or organic), so scenario engines can log and react.

Verdicts are ``(action, arg)`` tuples:

=========  =====================  ==========================================
action     arg                    effect
=========  =====================  ==========================================
``pass``   ``None``               message proceeds untouched
``drop``   ``None``               message silently vanishes
``delay``  seconds (float)        message delivered after ``arg`` seconds
``dup``    extra copies (int)     message proceeds AND ``arg`` extra copies
                                  are delivered immediately after
=========  =====================  ==========================================

Hook implementations must be non-blocking and exception-free: they run
inline on the IO loop for every message. The Rpc treats a hook exception
as a protocol error on that connection (the conn is dropped), so a buggy
scenario cannot silently corrupt an experiment.
"""

from __future__ import annotations

import struct
from typing import Any, List, Optional, Tuple

from . import serial

__all__ = [
    "PASS",
    "DROP",
    "DELAY",
    "DUP",
    "Verdict",
    "FaultHooks",
    "frame_ids",
]

PASS = "pass"
DROP = "drop"
DELAY = "delay"
DUP = "dup"

#: (action, arg) — see module docstring for the vocabulary.
Verdict = Tuple[str, Optional[Any]]

#: The no-op verdict, shared so hot paths can compare identity.
PASS_VERDICT: Verdict = (PASS, None)

# Body head starts right after the 12-byte frame header:
# u64 rid | u32 fid (serial._BODY_HEAD prefix).
_RID_FID = struct.Struct("<QI")


def frame_ids(frames: List[Any]) -> Tuple[int, int]:
    """Extract ``(rid, fid)`` from a serialized frame list without
    deserializing the body — the send seam's cheap message identity."""
    return _RID_FID.unpack_from(frames[0], serial.HEADER.size)


class FaultHooks:
    """Base hooks object: passes everything. Subclass (or duck-type) and
    install on an Rpc with ``rpc.install_fault_hooks(hooks)``.

    ``conn`` is the live ``_Conn`` — ``conn.peer_name`` is ``None`` until
    the greeting exchange binds it, so name-based scenario engines should
    also match greeting payloads on the recv seam.
    """

    def filter_send(self, rpc, conn, rid: int, fid: int,
                    frames: List[Any]) -> Verdict:
        return PASS_VERDICT

    def filter_recv(self, rpc, conn, rid: int, fid: int, obj) -> Verdict:
        return PASS_VERDICT

    def on_conn_drop(self, rpc, conn, why: str) -> None:
        pass
