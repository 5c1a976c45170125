"""Port parity: the same-host shm lane of moolib_tpu_torch, held to the
reference's cases (tests/test_shmring.py): transport negotiation,
zero-copy delivery, and segment hygiene (no /dev/shm leaks). The
cross-package lanes are in test_torch_rpc.py.

The rendezvous contract under test (the port's rpc/rpc.py +
rpc/shmring.py):

- same-host peers (matching boot identity, both shm-willing) mount the
  shm lane automatically alongside TCP and large payloads ride it;
- a peer claiming a DIFFERENT boot identity (cross-host) never gets an
  offer, and a peer with ``MOOLIB_TPU_SHM=0`` interops cleanly with an
  enabled one — both pairs just stay on TCP;
- the creator's segment + doorbell FIFOs are unlinked on close, and the
  GC finalizer unlinks them even for an abandoned (never-closed) lane.
"""

import gc
import glob
import os
import time

import numpy as np
import pytest

from moolib_tpu_torch.rpc import Rpc
from moolib_tpu_torch.rpc import shmring


def _wait_shm(rpc: Rpc, peer: str, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        p = rpc._peers.get(peer)
        if p and "shm" in p.conns and not p.conns["shm"].is_closing():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture
def pair():
    host = Rpc("shm-host")
    client = Rpc("shm-client")
    host.listen("127.0.0.1:0")
    client.connect(host.debug_info()["listen"][0])
    yield host, client
    client.close()
    host.close()


def test_same_host_peers_select_shm(pair, rng):
    """Matching boot ids -> the lane mounts on BOTH peers, and a
    spill-sized payload rides it (per-transport byte counters prove the
    route; TCP only carries the rendezvous + greeting control bytes)."""
    host, client = pair
    host.define("echo", lambda x: x)
    client.sync("shm-host", "echo", 1)
    assert _wait_shm(client, "shm-host") and _wait_shm(host, "shm-client")

    arr = rng.standard_normal(1 << 19).astype(np.float32)  # 2MB: spill
    reg = client.telemetry.registry
    # The per-send exploration bandit may legally route a send over TCP
    # (~2.5%/send) — retry until one rides the lane (5 misses ~ 1e-8).
    for _ in range(5):
        out = client.sync("shm-host", "echo", arr)
        np.testing.assert_array_equal(out, arr)
        shm_out = reg.value("rpc_bytes_out_total", transport="shm") or 0
        if shm_out > arr.nbytes:
            break
    assert shm_out > arr.nbytes, (
        f"payload did not ride the shm lane ({shm_out} bytes)"
    )
    # Lane-labelled latency histogram exported for the arbitration.
    snap = client.telemetry.snapshot()
    assert any(
        sid.startswith("rpc_lane_latency_seconds") and 'transport="shm"'
        in sid for sid in snap
    ), "rpc_lane_latency_seconds{transport=shm} missing from snapshot"


def test_cross_host_spoofed_boot_identity_never_selects_shm():
    """A peer advertising a different boot id is (as far as the
    rendezvous can know) on another host: neither side may offer, and
    traffic stays on TCP."""
    host = Rpc("xh-host")
    client = Rpc("xh-client")
    client._boot_id = "spoofed-" + client._boot_id  # cross-host identity
    try:
        host.define("add", lambda a, b: a + b)
        host.listen("127.0.0.1:0")
        client.connect(host.debug_info()["listen"][0])
        assert client.sync("xh-host", "add", 2, 3) == 5
        time.sleep(0.5)  # a wrong offer would land well within this
        for rpc, peer in ((client, "xh-host"), (host, "xh-client")):
            conns = rpc._peers[peer].conns
            assert "shm" not in conns, (
                f"{rpc.get_name()} mounted shm across a boot-id mismatch"
            )
        assert not host._shm_pairs and not client._shm_pairs
    finally:
        client.close()
        host.close()


def test_shm_disabled_peer_interops_with_enabled_peer(monkeypatch, rng):
    """MOOLIB_TPU_SHM=0 on one peer: no lane forms (the disabled peer
    neither offers nor accepts), and calls — including multi-MB tensor
    payloads — work over TCP unchanged."""
    monkeypatch.setenv("MOOLIB_TPU_SHM", "0")
    host = Rpc("off-host")  # built with the lane disabled
    monkeypatch.setenv("MOOLIB_TPU_SHM", "1")
    client = Rpc("off-client")  # built with the lane enabled
    try:
        assert not host._shm_enabled and client._shm_enabled
        host.define("echo", lambda x: x)
        host.listen("127.0.0.1:0")
        client.connect(host.debug_info()["listen"][0])
        arr = rng.standard_normal(1 << 18).astype(np.float32)
        np.testing.assert_array_equal(
            client.sync("off-host", "echo", arr), arr
        )
        time.sleep(0.3)
        assert "shm" not in client._peers["off-host"].conns
        assert "shm" not in host._peers["off-client"].conns
        assert not host._shm_pairs and not client._shm_pairs
    finally:
        client.close()
        host.close()


def test_set_transports_can_disable_shm():
    """set_transports without "shm" refuses the lane too (the runtime
    mirror of the env gate), and still validates unknown names."""
    host = Rpc("st-host")
    client = Rpc("st-client")
    client.set_transports({"tcp"})
    try:
        host.define("f", lambda: "ok")
        host.listen("127.0.0.1:0")
        client.connect(host.debug_info()["listen"][0])
        assert client.sync("st-host", "f") == "ok"
        time.sleep(0.3)
        assert "shm" not in client._peers["st-host"].conns
        with pytest.raises(Exception):
            client.set_transports({"bogus"})
    finally:
        client.close()
        host.close()


def test_mounted_lane_unlinks_names_immediately(pair):
    """unlink-after-mount: once both peers hold their fds + mapping the
    creator drops the /dev/shm names, so a SIGKILL of either process
    cannot leak segment or doorbell entries for the lane's whole
    mounted lifetime — and the name-less lane still carries traffic."""
    host, client = pair
    host.define("echo", lambda x: x)
    client.sync("shm-host", "echo", 1)
    assert _wait_shm(client, "shm-host") and _wait_shm(host, "shm-client")
    # Both conns up => the accept was processed => names already gone.
    paths = [e["lane"].path for e in list(client._shm_pairs.values())] + \
            [e["lane"].path for e in list(host._shm_pairs.values())]
    assert paths, "no mounted lane to check"
    for p in paths:
        for suffix in ("", ".db0", ".db1"):
            assert not os.path.exists(p + suffix), (
                f"mounted lane kept a filesystem name: {p + suffix}"
            )
    arr = np.arange(1 << 19, dtype=np.float32)  # 2MB spill, post-unlink
    np.testing.assert_array_equal(
        client.sync("shm-host", "echo", arr), arr
    )


def test_segment_files_unlinked_on_close(pair):
    """Closing the cohort unlinks the creator's segment + both doorbell
    FIFOs — /dev/shm holds nothing of the pair afterwards."""
    host, client = pair
    host.define("n", lambda: None)
    client.sync("shm-host", "n")
    assert _wait_shm(client, "shm-host")
    paths = [e["lane"].path for e in host._shm_pairs.values()]
    paths += [e["lane"].path for e in client._shm_pairs.values()]
    assert paths
    client.close()
    host.close()
    for p in paths:
        for suffix in ("", ".db0", ".db1"):
            assert not os.path.exists(p + suffix), f"leaked {p + suffix}"


def test_abandoned_lane_finalizer_unlinks():
    """An shm lane dropped WITHOUT close() still cleans up via its GC
    finalizer: fds closed, segment + FIFOs unlinked."""
    lane = shmring.ShmLane.create()
    path = lane.path
    assert os.path.basename(path).startswith(shmring.SEGMENT_PREFIX)
    assert os.path.exists(path) and os.path.exists(path + ".db0")
    del lane
    gc.collect()
    for suffix in ("", ".db0", ".db1"):
        assert not os.path.exists(path + suffix), f"leaked {path + suffix}"


def test_no_shm_leak_after_cohort_churn():
    """Spinning up and closing several shm-paired cohorts leaves no new
    moolib segment files behind (the suite-wide leak guard)."""
    pattern = os.path.join(shmring.SHM_DIR, shmring.SEGMENT_PREFIX + "*")
    before = set(glob.glob(pattern))
    for _ in range(3):
        h, c = Rpc("churn-h"), Rpc("churn-c")
        h.define("p", lambda: 1)
        h.listen("127.0.0.1:0")
        c.connect(h.debug_info()["listen"][0])
        assert c.sync("churn-h", "p") == 1
        _wait_shm(c, "churn-h", timeout=5.0)
        c.close()
        h.close()
    after = set(glob.glob(pattern))
    assert after - before == set(), f"leaked segments: {after - before}"


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
def test_zero_copy_receive_aliases_slot_and_is_aligned(pair, dtype):
    """A spill-delivered tensor decodes as an ALIGNED view over shared
    memory (no copy): the handler-side array's base chain reaches the
    segment mapping, and mutating a copy is the documented contract.

    float64/complex128 pin the _FRAME_PAD frame placement: a frame at
    an aligned slot base would put the body at +12 and every dtype with
    alignment > 4 would silently take _decode_tensor's copy fallback
    (base would be an ndarray, not the segment mmap)."""
    host, client = pair
    seen = {}

    def probe(x):
        seen["aligned"] = bool(x.flags.aligned)
        seen["addr_mod"] = x.ctypes.data % np.dtype(dtype).alignment
        base = x
        while True:  # walk ndarray .base and memoryview .obj links
            nxt = getattr(base, "base", None)
            if nxt is None and isinstance(base, memoryview):
                nxt = base.obj
            if nxt is None or nxt is base:
                break
            base = nxt
        seen["base_type"] = type(base).__name__
        return float(abs(x[0]))

    host.define("probe", probe)
    client.sync("shm-host", "probe", np.zeros(4, np.float32))
    assert _wait_shm(client, "shm-host")
    arr = np.zeros((2 << 20) // np.dtype(dtype).itemsize, dtype)  # 2MB
    # The per-send exploration bandit may legally route a call over TCP
    # (~2.5%/send); alignment holds on BOTH lanes (alloc_aligned TCP
    # reassembly), but the mmap-base claim is shm-only — retry until a
    # send actually rides the lane (5 misses ~ 1e-8).
    for _ in range(5):
        assert client.sync("shm-host", "probe", arr) == 0.0
        assert seen["aligned"], "decoded tensor must be aligned"
        assert seen["addr_mod"] == 0
        if seen["base_type"] == "mmap":
            break
    assert seen["base_type"] == "mmap", (
        f"expected a zero-copy view over the segment mapping, base is "
        f"{seen['base_type']}"
    )


def test_inline_eligible_frame_larger_than_tiny_ring_spills(monkeypatch):
    """A frame under INLINE_MAX but over the env-shrunk ring's
    per-record bound (rec <= ring//2; the 64KB ring floor is smaller
    than INLINE_MAX) must fall through to the spill path instead of
    raising out of writelines and silently losing the message."""
    monkeypatch.setenv("MOOLIB_TPU_SHM_RING_MB", "0")  # clamped to 64KB
    host = Rpc("inl-host")
    client = Rpc("inl-client")
    try:
        host.define("echo", lambda x: x)
        host.listen("127.0.0.1:0")
        client.connect(host.debug_info()["listen"][0])
        client.sync("inl-host", "echo", 1)
        assert _wait_shm(client, "inl-host")
        arr = np.arange(25 << 10, dtype=np.float32)  # 100KB < INLINE_MAX
        for _ in range(3):
            out = client.sync("inl-host", "echo", arr)
            np.testing.assert_array_equal(out, arr)
    finally:
        client.close()
        host.close()


def test_lane_survives_tiny_geometry_and_chunked_frames(monkeypatch):
    """Pathological geometry (1MB ring, 1MB slots): frames larger than
    any slot stream through the ring chunked, and the lane still
    delivers exactly the payload sent."""
    monkeypatch.setenv("MOOLIB_TPU_SHM_RING_MB", "1")
    monkeypatch.setenv("MOOLIB_TPU_SHM_SLOT_MB", "1")
    monkeypatch.setenv("MOOLIB_TPU_SHM_SLOTS", "2")
    host = Rpc("tiny-host")
    client = Rpc("tiny-client")
    try:
        host.define("echo", lambda x: x)
        host.listen("127.0.0.1:0")
        client.connect(host.debug_info()["listen"][0])
        client.sync("tiny-host", "echo", 1)
        assert _wait_shm(client, "tiny-host")
        arr = np.arange(3 << 18, dtype=np.float32)  # 3MB > slot, > ring
        out = client.sync("tiny-host", "echo", arr)
        np.testing.assert_array_equal(out, arr)
    finally:
        client.close()
        host.close()


def test_lane_refused_when_the_tmpfs_cannot_hold_it(monkeypatch):
    """A /dev/shm smaller than a lane's sparse segment accepts the
    ftruncate and then kills the process with SIGBUS on the first write
    past its capacity: the port refuses such a lane up front, and the
    pair stays on its socket lane."""
    real = os.statvfs

    def tiny(path):
        st = real(path)
        return os.statvfs_result((st.f_bsize, st.f_frsize, st.f_blocks, 1,
                                  1, st.f_files, st.f_ffree, st.f_favail,
                                  st.f_flag, st.f_namemax))

    monkeypatch.setattr(shmring.os, "statvfs", tiny)
    with pytest.raises(OSError, match="free"):
        shmring.ShmLane.create()
    host, client = Rpc("full-host"), Rpc("full-client")
    try:
        host.define("echo", lambda x: x)
        host.listen("127.0.0.1:0")
        client.connect(host.debug_info()["listen"][0])
        arr = np.arange(1 << 18, dtype=np.float32)
        np.testing.assert_array_equal(client.sync("full-host", "echo", arr),
                                      arr)
        time.sleep(0.3)
        assert "shm" not in client._peers["full-host"].conns
        assert not host._shm_pairs and not client._shm_pairs
    finally:
        client.close()
        host.close()
