"""Port parity: the flight recorder, incident bundles, capture, the
cross-peer merge and the cohort crawl of moolib_tpu_torch against
moolib_tpu.

A bundle written by either package must validate and load in the other,
and the merge of the same bundles must give the same timeline in both.
Tolerance: exact (equal objects and JSON; there is no arithmetic beyond
integer timestamp shifts).
"""

import json
import os

import pytest

import moolib_tpu.flightrec as ref_fr
import moolib_tpu.telemetry as ref_tel
import moolib_tpu_torch.flightrec as port_fr
import moolib_tpu_torch.telemetry as port_tel

PKGS = [(ref_fr, ref_tel), (port_fr, port_tel)]


def _record(fr):
    fr.record("conn_up", 1_000_000, peer="y", transport="tcp")
    fr.record("group_epoch", 1_500_000, group="g", sync_id=3,
              members=("a", "b"), cancelled=False)
    fr.record("broker_dark", 2_000_000, group="g", broker="b",
              silence_s=4.5)
    fr.record("step_phases", 2_500_000, loop="learner", steps=64,
              wall_s=1.25, exposed_comms=0.0, host_blocked=0.5,
              env_wait=None)


def test_recorder_events_match_reference():
    assert port_fr.KINDS == ref_fr.KINDS
    rings = []
    for fr_mod, _ in PKGS:
        fr = fr_mod.FlightRecorder("t", capacity=3, enabled=True)
        _record(fr)
        assert fr.dropped == 1 and len(fr) == 3
        with pytest.raises(ValueError, match="unknown flightrec event kind"):
            fr.record("not_a_kind", peer="x")
        with pytest.raises(ValueError, match="requires exactly fields"):
            fr.record("conn_up", peer="x")
        with pytest.raises(ValueError, match="JSON scalar"):
            fr.record("conn_up", peer={"x": 1}, transport="tcp")
        rings.append(fr.events())
    assert rings[0] == rings[1]
    assert rings[1][0]["fields"]["members"] == ["a", "b"]


def test_recorder_gate_reads_the_reference_environment(monkeypatch):
    monkeypatch.setenv("MOOLIB_TPU_FLIGHTREC", "0")
    assert not port_fr.FlightRecorder("t").on
    monkeypatch.setenv("MOOLIB_TPU_FLIGHTREC", "1")
    fr = port_fr.FlightRecorder("t")
    assert fr.on
    fr.set_enabled(False)
    assert not fr.on
    fr.record("conn_up", peer="y", transport="tcp")  # seams gate, not record
    fr.clear()
    assert len(fr) == 0 and fr.dropped == 0


def _sample_bundle(fr_mod, tel_mod, name="peerx"):
    tel = tel_mod.Telemetry(name, enabled=True, tracing=True)
    _record(tel.flight)
    tel.traces.add_span("call echo", "rpc", name, 1_500_000, 250,
                        trace_id="tid1", args={"peer": "y"})
    tel.traces.add_span("handle echo", "rpc", name, 1_499_000, 100,
                        trace_id="tid1", args={"obj": object()})
    tel.traces.add_instant("chaos drop", "chaos", name, 1_600_000)
    tel.registry.counter("some_total", service="s").inc(3)
    tel.registry.histogram("lat_seconds").observe(0.01)
    return fr_mod.snapshot_bundle(tel, trigger="api", detail="unit",
                                  include_global=False)


@pytest.mark.parametrize("writer,reader", [(0, 1), (1, 0), (1, 1)],
                         ids=["ref-to-port", "port-to-ref", "port-to-port"])
def test_bundles_cross_validate(tmp_path, writer, reader):
    w_fr, w_tel = PKGS[writer]
    r_fr, _ = PKGS[reader]
    bundle = _sample_bundle(w_fr, w_tel)
    assert r_fr.validate_bundle(bundle) is bundle
    path = w_fr.write_bundle(bundle, str(tmp_path))
    assert os.path.basename(path).startswith("incident_peerx_")
    assert r_fr.load_bundle(path) == bundle
    handle = next(s for s in bundle["spans"] if s["name"] == "handle echo")
    assert handle["args"]["obj"].startswith("<object")  # stringified


def test_bundle_strict_rejection_matches_reference(tmp_path):
    good = _sample_bundle(port_fr, port_tel)
    mutations = [
        (lambda b: b.update(surprise=1), "top-level keys"),
        (lambda b: b.update(events=None), "must be a list"),
        (lambda b: b.pop("stacks"), "top-level keys"),
        (lambda b: b.update(version=99), "version"),
        (lambda b: b.update(schema="other"), "schema"),
        (lambda b: b["events"][0].update(kind="zzz"), "unknown kind"),
        (lambda b: b["events"][0]["fields"].update(extra=1),
         "requires exactly fields"),
        (lambda b: b["events"][0].update(ts_us="soon"), "must be ints"),
        (lambda b: b["spans"][0].update(ph="Q"), "ph"),
        (lambda b: b.update(trigger={"kind": "api"}), "trigger"),
        (lambda b: b.update(metrics={"x": {"s": {"no_type": 1}}}),
         "registry snapshot"),
        (lambda b: b.update(events_dropped=-1), "non-negative"),
        (lambda b: b.update(fingerprint={"python": "3"}), "fingerprint"),
    ]
    for mutate, match in mutations:
        bad = json.loads(json.dumps(good))
        mutate(bad)
        for fr_mod, _ in PKGS:
            with pytest.raises(ValueError, match=match):
                fr_mod.validate_bundle(bad)
    p = tmp_path / "trunc.json"
    p.write_text(json.dumps(good)[:40])
    for fr_mod, _ in PKGS:
        with pytest.raises(ValueError, match="invalid flightrec bundle"):
            fr_mod.load_bundle(str(p))
    assert port_fr.BUNDLE_SCHEMA == ref_fr.BUNDLE_SCHEMA
    assert port_fr.BUNDLE_VERSION == ref_fr.BUNDLE_VERSION


def test_fingerprint_names_the_cards_environment(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("NCCL_DEBUG", "WARN")
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    monkeypatch.setenv("TORCH_SHOW_CPP_STACKTRACES", "1")
    monkeypatch.setenv("MOOLIB_TPU_TRACE", "0")
    monkeypatch.setenv("XLA_FLAGS", "--x")
    env = _sample_bundle(port_fr, port_tel)["fingerprint"]["env"]
    for k in ("CUDA_VISIBLE_DEVICES", "NCCL_DEBUG", "PYTORCH_CUDA_ALLOC_CONF",
              "TORCH_SHOW_CPP_STACKTRACES", "MOOLIB_TPU_TRACE"):
        assert k in env
    assert not any(k.startswith(("XLA", "JAX")) for k in env)
    assert "XLA_FLAGS" in _sample_bundle(ref_fr, ref_tel)["fingerprint"]["env"]


def _pair(fr_mod, tel_mod):
    """Three peers' bundles: B's clock 5s ahead, a handler span landing
    before its caller, and C pulling the same track as A (two peers of
    one process share the global track)."""
    ta = tel_mod.Telemetry("A", enabled=True, tracing=True)
    tb = tel_mod.Telemetry("B", enabled=True, tracing=True)
    for ts, p in ((1_000_000, "e1"), (3_000_000, "e3")):
        ta.flight.record("conn_up", ts, peer=p, transport="tcp")
    for ts, p in ((2_000_000, "e2"), (4_000_000, "e4")):
        tb.flight.record("conn_up", ts, peer=p, transport="tcp")
    ta.traces.add_span("call f", "rpc", "A", 2_000_000, 500, trace_id="t1")
    tb.traces.add_span("handle f", "rpc", "B", 1_999_000, 200,
                       trace_id="t1")
    tb.traces.add_instant("chaos drop", "chaos", "B", 2_100_000)
    ta.flight.record("incident", 2_200_000, trigger="api", detail="x")
    a = fr_mod.snapshot_bundle(ta, include_global=False)
    b = fr_mod.shift_bundle_ts(
        fr_mod.snapshot_bundle(tb, include_global=False), 5_000_000)
    return {"A": a, "B": b, "C": json.loads(json.dumps(a))}


def test_merge_gives_the_reference_timeline(tmp_path):
    ref_bundles = _pair(ref_fr, ref_tel)
    port_bundles = _pair(port_fr, port_tel)
    for b in (*ref_bundles.values(), *port_bundles.values()):
        b["stacks"], b["fingerprint"], b["captured_at_us"] = "", {
            "python": "3", "pid": 1, "env": {}}, 0
    assert port_bundles == ref_bundles
    for offsets in (None, {"B": 5_000_000}):
        ref_tl, ref_meta = ref_fr.merge_bundles(ref_bundles, offsets)
        port_tl, port_meta = port_fr.merge_bundles(port_bundles, offsets)
        assert port_tl == ref_tl and port_meta == ref_meta
        assert json.dumps(port_fr.timeline_to_chrome(port_tl, port_meta)) \
            == json.dumps(ref_fr.timeline_to_chrome(ref_tl, ref_meta))
        paths = [tmp_path / f"{n}.jsonl" for n in ("ref", "port")]
        ref_fr.write_timeline_jsonl(ref_tl, str(paths[0]))
        port_fr.write_timeline_jsonl(port_tl, str(paths[1]))
        assert paths[0].read_bytes() == paths[1].read_bytes()
    # Aligned: the conn_up events in true order, C's copy of A's track
    # dropped, the handler clamped after its caller.
    events = [r["fields"].get("peer") for r in port_tl
              if r["type"] == "event" and r["kind"] == "conn_up"]
    assert events == ["e1", "e2", "e3", "e4"]
    assert port_meta["causal_adjustments"] == 1
    assert port_meta["deduplicated"] == 4  # 3 events and 1 span of A's


class _FakeRpc:
    """Answers ``__flightrec`` ``op="time"`` with a clock ``skew_us``
    ahead of the caller's (duck-typed stand-in for an Rpc peer)."""

    def __init__(self, now_us, skew_us):
        self.now_us, self.skew_us, self.calls = now_us, skew_us, 0

    def sync(self, peer, endpoint, **kwargs):
        assert (endpoint, kwargs) == ("__flightrec", {"op": "time"})
        self.calls += 1
        return {"time_us": self.now_us() + self.skew_us}


def test_estimate_offset_with_a_duck_typed_rpc():
    for skew in (3_000_000, -2_000_000, 0):
        rpc = _FakeRpc(port_tel.now_us, skew)
        off, rtt = port_fr.estimate_offset(rpc, "peer", samples=4)
        assert rpc.calls == 4 and rtt >= 0
        assert abs(off - skew) <= rtt + 1_000
    with pytest.raises(ValueError, match="samples"):
        port_fr.estimate_offset(_FakeRpc(port_tel.now_us, 0), "p", 0)


def test_capture_incident_and_rate_limited_auto(tmp_path):
    tel = port_tel.Telemetry("cap")
    tel.flight.record("conn_up", peer="y", transport="tcp")
    path = port_fr.capture_incident("api", "unit test", telemetry=tel,
                                    out_dir=str(tmp_path / "api"))
    for fr_mod, _ in PKGS:
        b = fr_mod.load_bundle(path)
        assert b["trigger"] == {"kind": "api", "detail": "unit test"}
        assert [e["kind"] for e in b["events"]
                if e["pid"] == "cap"] == ["conn_up", "incident"]
        assert "global" in b["metrics"] and "cap" in b["metrics"]
    assert tel.registry.value("flightrec_incidents_total",
                              trigger="api") == 1
    assert port_fr.recent_captures()[-1]["path"] == path
    port_fr.disable_auto_capture()
    try:
        assert port_fr.maybe_capture("breaker_open", "x",
                                     telemetry=tel) is None
        port_fr.enable_auto_capture(str(tmp_path / "auto"))
        assert port_fr.auto_capture_dir() == str(tmp_path / "auto")
        first = port_fr.maybe_capture("breaker_open", "x", telemetry=tel)
        assert first is not None and os.path.exists(first)
        # Rate-limited per trigger kind; another kind still captures.
        assert port_fr.maybe_capture("breaker_open", "y",
                                     telemetry=tel) is None
        assert port_fr.maybe_capture("worker_budget_exhausted", "z",
                                     telemetry=tel) is not None
    finally:
        port_fr.disable_auto_capture()
    assert port_fr.auto_capture_dir() is None or os.environ.get(
        "MOOLIB_TPU_INCIDENT_DIR")


def test_public_surface_matches_reference_without_the_crawl():
    # The crawl came with the port's RPC core: the surfaces are equal.
    assert sorted(port_fr.__all__) == sorted(ref_fr.__all__)
    import moolib_tpu_torch as port

    for name in ("Telemetry", "global_telemetry", "publish_metrics",
                 "FlightRecorder", "capture_incident", "enable_auto_capture",
                 "set_log_level", "set_logging", "create_uid"):
        assert name in port.__all__, name
        assert getattr(port, name) is not None
    assert port.FlightRecorder is port_fr.FlightRecorder
    uid = port.create_uid()
    assert len(uid) == 32 and uid != port.create_uid()


# -- over the RPC --------------------------------------------------------------


def test_estimate_offset_against_a_live_port_peer():
    from moolib_tpu_torch.rpc import Rpc

    a, b = Rpc("clk-a"), Rpc("clk-b")
    try:
        b.listen("127.0.0.1:0")
        a.connect(b.debug_info()["listen"][0])
        a.async_("clk-b", "__flightrec", op="time").result(timeout=20)
        for skew in (3_000_000, -2_000_000, 0):
            b.set_flightrec_skew(skew)
            off, rtt = port_fr.estimate_offset(a, "clk-b")
            assert abs(off - skew) < 25_000, (skew, off, rtt)
    finally:
        a.close()
        b.close()


def test_crawl_cohort_reaches_every_port_peer_from_one_address():
    """One address (a hub) leads to the whole cohort: the crawl walks the
    neighbour lists each ``__flightrec`` snapshot advertises, and every
    bundle it brings back validates in both packages."""
    from moolib_tpu_torch.rpc import Rpc

    hub, leaf, crawler = Rpc("cr-hub"), Rpc("cr-leaf"), Rpc("cr-crawler")
    for p in (hub, leaf, crawler):
        p.set_timeout(20.0)
    try:
        hub.listen("127.0.0.1:0")
        leaf.listen("127.0.0.1:0")
        leaf.connect(hub.debug_info()["listen"][0])
        leaf.async_("cr-hub", "__flightrec", op="time").result(timeout=20)
        leaf.telemetry.flight.record("conn_up", peer="x", transport="tcp")

        def scrape(peer):
            reply = crawler.async_(peer, "__flightrec").result(timeout=20)
            return reply["bundle"], reply["peers"]

        seen = []
        results, failed = port_fr.crawl_cohort(
            crawler, [hub.debug_info()["listen"][0]], scrape,
            on_result=lambda peer, _b: seen.append(peer))
        assert failed == []
        assert sorted(results) == ["cr-hub", "cr-leaf"] == sorted(seen)
        for name, bundle in results.items():
            for fr_mod, _ in PKGS:
                fr_mod.validate_bundle(bundle)  # raises when invalid
            assert bundle["trigger"]["kind"] == "scrape"
        kinds = [e["kind"] for e in results["cr-leaf"]["events"]
                 if e["pid"] == "cr-leaf"]
        assert "conn_up" in kinds
        # A pinned set crawls only what it names, and a dark peer is a
        # finding, not a failure of the crawl.
        crawler.set_timeout(1.0)
        results, failed = port_fr.crawl_cohort(
            crawler, [], scrape, want=["cr-hub", "cr-ghost"],
            discover_seconds=0.1)
        assert sorted(results) == ["cr-hub"]
        assert [p for p, _ in failed] == ["cr-ghost"]
    finally:
        for p in (crawler, leaf, hub):
            p.close()
