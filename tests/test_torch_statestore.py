"""Port parity: the durable-state tier (moolib_tpu_torch.statestore),
held against the reference's (moolib_tpu.statestore).

- The bundle format is byte-compatible: for one tree of numpy leaves
  both packages give the same blob, chunks, manifest, manifest hash and
  files on disk (exact). Torch leaves (bf16 included) round-trip bit for
  bit through the port.
- The layers as the reference's tests pin them, on the port: manifest
  validation, the crash-atomic disk protocol, the store's put/GC/budget
  and degraded-mode contract under injected ENOSPC (ResourceChaos), the
  StateStoreService wire family and the restore negotiation's edge
  cases, and the Replicator's ring placement widening by one while its
  store is degraded.
- A mixed loopback cohort: a port store publishes to a reference
  follower, a reference store to a port follower, and each package
  restores the other's publish by quorum 2 with the same bytes.
- Without ``ml_dtypes`` (the card machine has none) a port bundle of
  bf16 tensors decodes, and a reference bundle of ml_dtypes bf16 arrays
  is refused with BundleCorrupt naming the dtype.

Small sizes throughout (chunk_bytes 64-256). Every wait has a deadline.
"""

import collections
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from moolib_tpu.rpc import Rpc as RefRpc
from moolib_tpu.statestore import StateStore as RefStateStore
from moolib_tpu.statestore import bundle as ref_bundle
from moolib_tpu_torch.rpc import Rpc, RpcError
from moolib_tpu_torch.statestore import (LOCAL, BundleCorrupt, Replicator,
                                         StateStore, WriteFailed, bundle)
from moolib_tpu_torch.telemetry import Telemetry
from moolib_tpu_torch.testing.chaos import ResourceChaos, ResourceFaultPlan

REPO_ROOT = Path(__file__).resolve().parent.parent
Pair = collections.namedtuple("Pair", "first second")


def _states():
    rng = np.random.RandomState(11)
    w = rng.randn(300).astype(np.float32)
    return {
        "flat": {"w": w, "step": 9},
        "nested": {"params": {"b": rng.randn(7), "a": w[:5].copy()},
                   "opt": [np.int64(3), 2.5, "adam", None],
                   "pair": Pair(np.float32(1.0), (w[:2].copy(),))},
        "aliased": {"z": w, "y": w, "x": {"k": True}},
        "empty": {},
    }


@pytest.mark.parametrize("chunk_bytes", [64, 256, bundle.CHUNK_BYTES_DEFAULT])
@pytest.mark.parametrize("name", sorted(_states()))
def test_bundle_is_byte_identical_to_the_reference(name, chunk_bytes,
                                                   tmp_path):
    state = _states()[name]
    blob = bundle.encode_state(state)
    assert blob == ref_bundle.encode_state(state)
    chunks = bundle.chunk_blob(blob, chunk_bytes)
    assert chunks == ref_bundle.chunk_blob(blob, chunk_bytes)
    m = bundle.manifest_for(5, chunks, {"who": name})
    assert m == ref_bundle.manifest_for(5, chunks, {"who": name})
    assert bundle.manifest_hash(m) == ref_bundle.manifest_hash(m)
    bundle.write_version(str(tmp_path / "port"), 5, m, chunks)
    ref_bundle.write_version(str(tmp_path / "ref"), 5, m, chunks)
    for f in sorted(os.listdir(bundle.version_dir(str(tmp_path / "ref"), 5))):
        assert (Path(bundle.version_dir(str(tmp_path / "port"), 5)) / f
                ).read_bytes() == (Path(ref_bundle.version_dir(
                    str(tmp_path / "ref"), 5)) / f).read_bytes(), f
    # Each package decodes the other's blob.
    back = ref_bundle.decode_state(blob)
    assert pickle.dumps(back) == pickle.dumps(bundle.decode_state(blob))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.float16])
def test_tensor_leaves_round_trip_bit_for_bit(dtype):
    gen = torch.Generator().manual_seed(3)
    t = (torch.randn(33, 5, generator=gen) * 100).to(dtype)
    state = {"params": {"w": t, "b": t[0].clone()}, "step": 4,
             "view": t[:, 1]}
    got = bundle.decode_state(bundle.encode_state(state))
    for k in ("b", "w"):
        assert got["params"][k].dtype == dtype
        assert torch.equal(got["params"][k], state["params"][k])
    assert torch.equal(got["view"], t[:, 1]) and got["step"] == 4


def test_validate_manifest_rejects_malformed_like_the_reference():
    good = bundle.manifest_for(1, [b"abc"])
    assert bundle.validate_manifest(good) is good
    bad = [
        {"magic": "nope"},
        {**good, "extra": 1},
        {**good, "version": -1},
        {**good, "meta": []},
        {**good, "chunks": []},
        {**good, "chunks": [{"i": 1, "size": 3,
                             "sha256": good["chunks"][0]["sha256"]}]},
        {**good, "total_bytes": 99},
    ]
    for m in bad:
        with pytest.raises(BundleCorrupt) as port:
            bundle.validate_manifest(m)
        with pytest.raises(ref_bundle.BundleCorrupt) as ref:
            ref_bundle.validate_manifest(m)
        assert str(port.value) == str(ref.value)


def test_corrupt_chunk_truncation_sweep_and_gc_rename(tmp_path):
    root = str(tmp_path / "store")
    chunks = bundle.chunk_blob(b"q" * 700, 256)
    bundle.write_version(root, 2, bundle.manifest_for(2, chunks), chunks)
    path = os.path.join(bundle.version_dir(root, 2), "c000001.bin")
    raw = bytearray(open(path, "rb").read())
    raw[10] ^= 0x01
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(BundleCorrupt, match="chunk 1"):
        bundle.verify_version(root, 2)
    os.unlink(path)
    with pytest.raises(BundleCorrupt, match="missing"):
        bundle.verify_version(root, 2)
    # What a crash mid-write / mid-GC strands is invisible, then swept.
    os.makedirs(os.path.join(root, ".stage-v000000000003-abc"))
    os.makedirs(os.path.join(root, ".gc-v000000000000-123"))
    assert bundle.list_versions(root) == [2]
    assert bundle.sweep(root) == 2
    assert bundle.remove_version(root, 2) is True
    assert bundle.remove_version(root, 2) is False
    assert os.listdir(root) == []
    with pytest.raises(FileNotFoundError):
        bundle.read_manifest(root, 2)


def test_store_put_load_gc_and_disk_budget(tmp_path):
    # Each store records into a Telemetry of its own: the global one is
    # shared by every test that runs in this process.
    store = StateStore(str(tmp_path / "s"), None, chunk_bytes=64,
                       keep_versions=2, name="local",
                       telemetry=Telemetry("ss-local"))
    try:
        for v in range(1, 5):
            store.put(v, {"w": np.full(50, v, np.float32)})
        assert [v for v, _h in store.versions()] == [3, 4]
        np.testing.assert_array_equal(store.load(4)["w"],
                                      np.full(50, 4, np.float32))
        reg = store._tel.registry
        assert reg.value("statestore_gc_versions_total") == 2
        assert reg.value("statestore_put_total") == 4
    finally:
        store.close()
    store = StateStore(str(tmp_path / "b"), None, chunk_bytes=64,
                       keep_versions=10, disk_budget_bytes=1, name="budget",
                       telemetry=Telemetry("ss-budget"))
    try:
        store.put(1, {"w": np.zeros(50, np.float32)})
        store.put(2, {"w": np.ones(50, np.float32)})
        assert [v for v, _h in store.versions()] == [2]
    finally:
        store.close()


def test_enospc_on_a_chunk_write_degrades_and_recovers(tmp_path):
    store = StateStore(str(tmp_path / "s"), None, chunk_bytes=64,
                       name="faulty", telemetry=Telemetry("ss-faulty"))
    try:
        store.put(1, {"w": np.zeros(40, np.float32)})
        plan = ResourceFaultPlan(0).enospc("v*/c*.bin", op="write", after=1)
        with ResourceChaos(plan, root=store.root):
            with pytest.raises(WriteFailed) as ei:
                store.put(2, {"w": np.ones(40, np.float32)})
        assert ei.value.__cause__.errno == 28
        assert store.degraded is True
        reg = store._tel.registry
        assert reg.value("statestore_write_failures_total", op="write") == 1
        ev = [e for e in store._tel.flight.events()
              if e["kind"] == "ss_write_failure"]
        assert ev and ev[-1]["fields"]["version"] == 2
        assert store.verify_all() == [1]
        assert sorted(os.listdir(store.root)) == ["v000000000001"]
        assert [(e.kind, e.arg) for e in plan.events] == [
            ("enospc", "c000001.bin")]
        store.put(3, {"w": np.full(40, 3, np.float32)})
        assert store.degraded is False
        assert [v for v, _h in store.versions()] == [1, 3]
    finally:
        store.close()


def _wire(tmp_path, n=3, chunk_bytes=128, tag="w", pkgs=None):
    pkgs = pkgs or ["port"] * n
    cls = {"port": (Rpc, StateStore), "ref": (RefRpc, RefStateStore)}
    rpcs = [cls[p][0](f"ss{tag}{i}") for i, p in enumerate(pkgs)]
    for r in rpcs:
        r.listen("127.0.0.1:0")
    for i, r in enumerate(rpcs):
        for other in rpcs[i + 1:]:
            r.connect(other.debug_info()["listen"][0])
    stores = [cls[p][1](str(tmp_path / f"s{tag}{i}"), r,
                        chunk_bytes=chunk_bytes, name=f"ss{tag}{i}")
              for i, (p, r) in enumerate(zip(pkgs, rpcs))]
    return rpcs, stores


def _close(rpcs, stores):
    for s in stores:
        s.close()
    for r in rpcs:
        r.close()


def test_publish_replicate_offer_dedup_and_restore(tmp_path):
    rpcs, stores = _wire(tmp_path, tag="p")
    try:
        state = {"w": np.arange(200, dtype=np.float64)}
        assert stores[0].publish(9, state, peers=("ssp1",)) == {
            LOCAL: True, "ssp1": True}
        assert dict(stores[1].versions()) == dict(stores[0].versions())
        reg1 = rpcs[1].telemetry.registry
        ingested = reg1.value("statestore_ingest_chunks_total")
        assert stores[0].replicate(9, ("ssp1",)) == {"ssp1": True}
        assert reg1.value("statestore_ingest_chunks_total") == ingested
        got = stores[2].restore(("ssp0", "ssp1"), quorum=2)
        assert got is not None and got[0] == 9
        np.testing.assert_array_equal(got[1]["w"], state["w"])
        assert dict(stores[2].versions()) == dict(stores[0].versions())
        with pytest.raises(RuntimeError, match="already registered"):
            StateStore(str(tmp_path / "again"), rpcs[0], name="again")
    finally:
        _close(rpcs, stores)


def test_ingest_rejects_corrupt_chunk_and_commit_requires_all(tmp_path):
    rpcs, stores = _wire(tmp_path, n=2, tag="i")
    try:
        chunks = bundle.chunk_blob(bundle.encode_state({"x": 1}), 64)
        assert len(chunks) >= 2
        m = bundle.manifest_for(4, chunks)
        svc = StateStore.SERVICE
        assert rpcs[0].sync("ssi1", f"{svc}::offer", m) is True
        with pytest.raises(RpcError, match="fails verification"):
            rpcs[0].sync("ssi1", f"{svc}::ingest", 4, 0, b"\x00" * 64)
        rpcs[0].sync("ssi1", f"{svc}::ingest", 4, 0, chunks[0])
        with pytest.raises(RpcError, match="missing"):
            rpcs[0].sync("ssi1", f"{svc}::commit", 4)
        for i, c in enumerate(chunks[1:], start=1):
            rpcs[0].sync("ssi1", f"{svc}::ingest", 4, i, c)
        assert rpcs[0].sync("ssi1", f"{svc}::commit", 4) is True
        assert [v for v, _h in stores[1].versions()] == [4]
        with pytest.raises(RpcError, match="no staged offer"):
            rpcs[0].sync("ssi1", f"{svc}::ingest", 99, 0, chunks[0])
    finally:
        _close(rpcs, stores)


def test_negotiate_falls_back_when_the_newest_lacks_quorum(tmp_path):
    rpcs, stores = _wire(tmp_path, tag="n")
    try:
        agreed = {"w": np.arange(64, dtype=np.float32)}
        assert all(stores[0].publish(4, agreed, peers=("ssn1",)).values())
        stores[0].put(5, {"w": np.zeros(64, np.float32)})
        stores[1].put(5, {"w": np.ones(64, np.float32)})
        neg = stores[2].negotiate(("ssn0", "ssn1"), quorum=2)
        assert neg is not None and neg.version == 4
        assert sorted(neg.holders) == ["ssn0", "ssn1"]
        n1 = stores[2].negotiate(("ssn0", "ssn1"), quorum=1)
        n2 = stores[2].negotiate(("ssn1", "ssn0"), quorum=1)
        assert n1.version == 5 and n1.manifest_hash == n2.manifest_hash
    finally:
        _close(rpcs, stores)


def test_negotiate_drops_a_tampered_manifest_and_restore_repairs(tmp_path):
    rpcs, stores = _wire(tmp_path, n=2, tag="t")
    try:
        stores[0].put(6, {"w": np.full(30, 6.0, np.float32)})
        stores[0].put(7, {"w": np.full(30, 7.0, np.float32)})
        mp = bundle.manifest_path(stores[0].root, 7)
        m = json.load(open(mp))
        m["meta"] = {"tampered": True}
        with open(mp, "w") as f:
            json.dump(m, f)
        got = stores[1].restore(("sst0",), quorum=1)
        assert got is not None and got[0] == 6
        np.testing.assert_array_equal(got[1]["w"],
                                      np.full(30, 6.0, np.float32))
        # A rotten local copy of the negotiated version is repaired from
        # the peer that holds it.
        state = {"w": np.arange(120, dtype=np.float64)}
        assert all(stores[1].publish(3, state, peers=("sst0",)).values())
        path = os.path.join(bundle.version_dir(stores[1].root, 3),
                            "c000001.bin")
        with open(path, "r+b") as f:
            f.seek(2)
            f.write(b"\xde\xad")
        for st in stores:  # only v3 left to negotiate
            for v in (6, 7):
                bundle.remove_version(st.root, v)
                st._verified.pop(v, None)
        got = stores[1].restore(("sst0",), quorum=2)
        assert got is not None and got[0] == 3
        np.testing.assert_array_equal(got[1]["w"], state["w"])
        assert stores[1].verify_all() == [3]
    finally:
        _close(rpcs, stores)


class _FakeGroup:
    def __init__(self, members):
        self.members = members


class _FakeAcc:
    """The Accumulator surface a Replicator reads, with a version the
    test advances."""

    def __init__(self, rpc, members):
        self.rpc = rpc
        self.group = _FakeGroup(members)
        self.version = 0
        self.hook = "unset"

    def set_durability_hook(self, fn):
        self.hook = fn

    def is_leader(self):
        return True

    def has_gradients(self):
        return False

    def result_model_version(self):
        return self.version


def _published(rep, version, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with rep._lock:
            if version in rep.published:
                return rep.published[version]
        time.sleep(0.01)
    raise AssertionError(f"version {version} never published")


def test_degraded_store_moves_the_durability_role_along_the_ring(tmp_path):
    """followers=1: a healthy leader pushes to the next member of the
    sorted ring; after an injected ENOSPC on a chunk write its store is
    degraded and the next version goes to one more member; once the disk
    frees, the follower set narrows again. close() clears the hook."""
    rpcs, stores = _wire(tmp_path, tag="r")
    acc = _FakeAcc(rpcs[1], ["ssr2", "ssr0", "ssr1"])
    w = {"w": np.zeros(100, np.float32)}
    rep = Replicator(stores[1], acc, state_fn=lambda: w, followers=1)
    try:
        assert acc.hook == rep._on_version
        acc.version = 1
        rep._on_version(1)
        assert _published(rep, 1) == {LOCAL: True, "ssr2": True}
        plan = ResourceFaultPlan(1).enospc("v*/c*.bin", op="write")
        with ResourceChaos(plan, root=stores[1].root):
            acc.version = 2
            rep._on_version(2)
            assert _published(rep, 2) == {LOCAL: False, "ssr2": True}
            assert stores[1].degraded
            acc.version = 3
            rep._on_version(3)
            assert _published(rep, 3) == {LOCAL: False, "ssr2": True,
                                          "ssr0": True}
        assert dict(stores[0].versions()).keys() == {3}
        acc.version = 4
        rep._on_version(4)
        assert _published(rep, 4) == {LOCAL: True, "ssr2": True,
                                      "ssr0": True}
        assert not stores[1].degraded
        acc.version = 5
        rep._on_version(5)
        assert _published(rep, 5) == {LOCAL: True, "ssr2": True}
    finally:
        rep.close()
        _close(rpcs, stores)
    assert acc.hook is None and not rep._thread.is_alive()


@pytest.mark.parametrize("publisher", ["port", "ref"])
def test_mixed_cohort_publishes_and_restores_across_packages(publisher,
                                                             tmp_path):
    """Four peers, two of each package. One publishes to a follower of
    the other package and one of its own; a fresh store of the other
    package then restores by quorum 2 from those two holders, and every
    holder's chunks and the restored state are the same bytes."""
    other = "ref" if publisher == "port" else "port"
    pkgs = [publisher, other, publisher, other]
    rpcs, stores = _wire(tmp_path, n=4, chunk_bytes=256, tag=publisher[0],
                         pkgs=pkgs)
    names = [r.get_name() for r in rpcs]
    rng = np.random.RandomState(5)
    state = {"params": {"w": rng.randn(400).astype(np.float32),
                        "b": rng.randn(9)}, "step": 12}
    try:
        acks = stores[0].publish(12, state, peers=(names[1], names[2]))
        assert acks == {"<local>": True, names[1]: True, names[2]: True}
        ads = [dict(s.versions()) for s in stores[:3]]
        assert ads[0] == ads[1] == ads[2] and 12 in ads[0]
        got = stores[3].restore((names[1], names[2]), quorum=2)
        assert got is not None and got[0] == 12
        assert bundle.encode_state(got[1]) == bundle.encode_state(state)
        assert dict(stores[3].versions()) == ads[0]
        m = bundle.read_manifest(stores[0].root, 12)
        for c in m["chunks"]:
            data = {bundle.read_chunk(s.root, 12, c["i"]) for s in stores}
            assert len(data) == 1, c["i"]
    finally:
        _close(rpcs, stores)


_NO_ML_DTYPES = r"""
import json, sys
sys.modules["ml_dtypes"] = None
from moolib_tpu_torch.statestore import BundleCorrupt, bundle
port = bundle.decode_state(open(sys.argv[1], "rb").read())
out = {"dtype": str(port["w"].dtype),
       "bits": port["w"].view(__import__("torch").int16).tolist()}
try:
    bundle.decode_state(open(sys.argv[2], "rb").read())
    out["ref"] = "decoded"
except BundleCorrupt as e:
    out["ref"] = str(e)
print(json.dumps(out))
"""


def test_without_ml_dtypes_port_bf16_decodes_and_reference_bf16_refused(
        tmp_path):
    w = torch.tensor([1.5, -2.25, 3e-3, 65504.0], dtype=torch.bfloat16)
    port_blob = tmp_path / "port.bin"
    port_blob.write_bytes(bundle.encode_state({"w": w}))
    ref_blob = tmp_path / "ref.bin"
    ref_blob.write_bytes(ref_bundle.encode_state(
        {"w": np.asarray(w.float().numpy(), dtype=ml_dtypes.bfloat16)}))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_ML_DTYPES, str(port_blob), str(ref_blob)],
        cwd=str(REPO_ROOT), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["dtype"] == "torch.bfloat16"
    assert got["bits"] == w.view(torch.int16).tolist()
    assert "ml_dtypes" in got["ref"] and "bfloat16" in got["ref"], got["ref"]
    # With ml_dtypes present the reference's bundle decodes as it is.
    back = bundle.decode_state(ref_blob.read_bytes())
    assert back["w"].dtype == ml_dtypes.bfloat16
