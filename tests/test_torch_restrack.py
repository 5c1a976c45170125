"""Port parity: restrack (moolib_tpu_torch.testing.restrack), the
resource tracker, mirroring the reference's tests/test_restrack.py.

Unit level: acquire/release pairing per tracked kind (threads, shm
segments, the port's Rpc, the port's gauge registrations), the leak
report naming the acquisition-site stack, and the weakref-entry
exemption. The port tracks only acquisitions made through its own
package or test files: the reference's Rpc, whose package name is a
prefix of the port's, stays invisible. Integration level: two of the
port's chaos scenarios run leak-free under the tracker.
"""

import gc
import multiprocessing.shared_memory as mp_shm
import threading
import weakref

import pytest

from moolib_tpu_torch.testing import ResourceLeak, ResourceTracker


class _Owner:
    """Something for a weakref-entry thread to hold a ref to."""


def _weakref_entry(ref, ev):
    # The thread-pins-self convention: module-level target, only a
    # weakref to the owner.
    ev.wait(5.0)


def test_thread_leak_names_acquisition_stack_then_release_clears():
    ev = threading.Event()
    with ResourceTracker() as t:
        tok = t.mark()
        th = threading.Thread(target=ev.wait, args=(5.0,), daemon=True)
        th.start()
        assert t.counts(since=tok) == {"thread": 1}
        with pytest.raises(ResourceLeak) as ei:
            t.assert_released(since=tok, what="thread fixture", grace=0.3)
        msg = str(ei.value)
        # The report carries the *acquisition* site — this file — not
        # the assert site, plus the kind and the thread identity.
        assert "[thread]" in msg
        assert "tests/test_torch_restrack.py" in msg
        assert "acquired at" in msg
        assert "thread fixture" in msg
        ev.set()
        th.join()
        t.assert_released(since=tok, what="thread fixture")


def test_weakref_entry_thread_exempt_while_alive():
    """A module-entry thread holding only a weakref cannot pin its owner
    (it exits once the owner dies), so it is not a leak while alive."""
    owner = _Owner()
    ev = threading.Event()
    with ResourceTracker() as t:
        tok = t.mark()
        th = threading.Thread(
            target=_weakref_entry, args=(weakref.ref(owner), ev),
            daemon=True,
        )
        th.start()
        assert th.is_alive()
        t.assert_released(since=tok, what="weakref-entry fixture",
                          grace=0.2)
        ev.set()
        th.join()


def test_rpc_create_close_pairing_and_collected_rpc_dropped():
    from moolib_tpu_torch.rpc.rpc import Rpc

    with ResourceTracker() as t:
        tok = t.mark()
        rpc = Rpc("restrack-pairing")
        assert t.counts(since=tok).get("rpc") == 1
        rpc.close()
        # close() pairs the rpc AND its io thread/executor exit: the
        # whole window must drain.
        t.assert_released(since=tok, what="rpc lifecycle")


def test_reference_rpc_is_neither_patched_nor_tracked():
    """The reference's Rpc keeps its own methods, and a reference peer
    created from this (port) test file records nothing: only the port's
    classes are patched."""
    from moolib_tpu.rpc.rpc import Rpc as RefRpc

    init = RefRpc.__init__
    with ResourceTracker() as t:
        assert RefRpc.__init__ is init
        tok = t.mark()
        rpc = RefRpc("restrack-ref")
        try:
            assert t.counts(since=tok).get("rpc") is None
        finally:
            rpc.close()


def test_shm_created_owes_unlink_attached_owes_close(tmp_path):
    with ResourceTracker() as t:
        tok = t.mark()
        seg = mp_shm.SharedMemory(create=True, size=64)
        try:
            att = mp_shm.SharedMemory(name=seg.name)
            assert t.counts(since=tok) == {"shm": 2}
            att.close()  # attached handle: close alone releases it
            assert t.counts(since=tok) == {"shm": 1}
            seg.close()  # created segment: close is NOT enough...
            assert t.counts(since=tok) == {"shm": 1}
        finally:
            seg.unlink()  # ...the /dev/shm entry owes an unlink
        t.assert_released(since=tok, what="shm fixture")


def test_gauge_registration_pairing_and_registry_death_releases():
    from moolib_tpu_torch.telemetry.registry import Registry

    with ResourceTracker() as t:
        reg = Registry()
        tok = t.mark()
        reg.gauge_fn("restrack_fixture_gauge", lambda: 1.0)
        assert t.counts(since=tok) == {"registration": 1}
        reg.unregister("restrack_fixture_gauge")
        t.assert_released(since=tok, what="gauge fixture")

        # A registration whose whole registry died is not a leak: nothing
        # outlives the owner when the registry goes too.
        tok = t.mark()
        reg2 = Registry()
        reg2.gauge_fn("restrack_dying_gauge", lambda: 1.0)
        assert t.counts(since=tok) == {"registration": 1}
        del reg2
        gc.collect()
        t.assert_released(since=tok, what="registry death fixture")


def test_mark_scopes_the_window():
    """Leaks from before mark() are out of scope: scenario N's check
    cannot be failed by scenario N-1's (already-reported) leak."""
    ev = threading.Event()
    with ResourceTracker() as t:
        th = threading.Thread(target=ev.wait, args=(5.0,), daemon=True)
        th.start()  # pre-window leak
        tok = t.mark()
        t.assert_released(since=tok, what="empty window")
        assert t.counts() == {"thread": 1}  # still visible unscoped
        ev.set()
        th.join()


def test_chaos_scenarios_restrack_clean():
    """Two of the port's chaos scenarios — one wire cohort, one envpool
    worker-kill — run under the tracker with every acquisition released
    by the end."""
    from moolib_tpu_torch.testing.scenarios import SCENARIOS

    with ResourceTracker() as t:
        tok = t.mark()
        SCENARIOS["drop_storm"](1)
        SCENARIOS["envpool_worker_kill"](3)
        # Non-vacuous: the scenarios must actually have acquired tracked
        # resources (threads, Rpcs, gauges) inside the window.
        assert t.mark() > tok, "no acquisitions tracked — tracker broken?"
        assert {a.kind for a in t._acqs[tok:]} >= {"thread", "rpc",
                                                   "registration"}
        t.assert_released(since=tok,
                          what="drop_storm + envpool_worker_kill")
