"""Port parity: the metrics registry, trace spans, Telemetry switches,
the logging knobs and the bench result schema of moolib_tpu_torch against
moolib_tpu.

The same seeded observations go to a fresh reference Registry/Telemetry
and a fresh port one. Tolerance: exact (equal JSON, byte-equal
Prometheus text, equal floats). Both packages do the same float
operations in the same order, so nothing may differ at all.
"""

import json
import math

import numpy as np
import pytest

import moolib_tpu.bench.harness as ref_harness
import moolib_tpu.telemetry as ref_tel
import moolib_tpu.telemetry.registry as ref_registry
import moolib_tpu.utils.logging as ref_logging
import moolib_tpu_torch.bench.harness as port_harness
import moolib_tpu_torch.telemetry as port_tel
import moolib_tpu_torch.telemetry.registry as port_registry
import moolib_tpu_torch.utils.logging as port_logging
from moolib_tpu_torch.utils.quantile import RollingQuantile as UtilsRQ

QS = (0.5, 0.9, 0.99)


def _feed(tel_mod, seed):
    """Seeded counters, gauges, gauge_fns and histograms with labels into
    a fresh Registry; returns it."""
    rng = np.random.default_rng(seed)
    reg = tel_mod.Registry()
    for i in range(40):
        svc = f"svc{rng.integers(3)}"
        reg.counter("serving_admitted_total", service=svc).inc(
            float(rng.integers(1, 5)))
        reg.counter("requests_total", service=svc,
                    reason=["cap", "drain", 'q"uo\\te\n'][i % 3]).inc(
            float(rng.random()))
        reg.gauge("queue_depth", service=svc).set(float(rng.normal()))
        reg.gauge("inflight").inc(float(rng.integers(0, 3)))
        reg.gauge("inflight").dec(1.0)
        # Log-uniform latencies over the default edges, and the edge
        # cases: exactly on an edge, zero, +inf, NaN (dropped).
        reg.histogram("latency_seconds", service=svc).observe(
            float(2.0 ** rng.uniform(-22, 8)))
        reg.histogram("fill", edges=tel_mod.FRACTION_EDGES,
                      service=svc).observe(float(rng.integers(1, 9)) / 8)
    h = reg.histogram("edge_cases_seconds")
    for v in (2.0 ** -20, 0.0, 1.0, math.inf, math.nan, 64.0, 100.0):
        h.observe(v)
    reg.histogram("empty_seconds")
    reg.gauge_fn("callback_gauge", lambda: 2.5, owner="a")
    reg.gauge_fn("broken_gauge", lambda: 1 / 0)  # degrades to NaN
    reg.counter("big_total").inc(1e16)
    reg.gauge("tiny").set(1.25e-7)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_exports_match_reference(seed):
    ref, port = _feed(ref_tel, seed), _feed(port_tel, seed)
    ref_snap, port_snap = ref.snapshot(), port.snapshot()
    assert json.dumps(port_snap) == json.dumps(ref_snap)
    ref_text, port_text = ref.prometheus(), port.prometheus()
    assert port_text == ref_text
    for sid, series in ref_snap.items():
        if series["type"] != "histogram":
            continue
        for q in QS:
            assert port_tel.quantile_from_export(port_snap[sid], q) == \
                ref_tel.quantile_from_export(series, q), (sid, q)
            assert port_tel.quantile_from_export(series, q) == \
                ref_tel.quantile_from_export(series, q)
    # Each package's parser reads both texts to the same values (NaN
    # compared through its JSON spelling).
    parsed = [json.dumps(parse(text), sort_keys=True)
              for parse in (ref_tel.parse_prometheus,
                            port_tel.parse_prometheus)
              for text in (ref_text, port_text)]
    assert len(set(parsed)) == 1


@pytest.mark.parametrize("tel_mod", [ref_tel, port_tel], ids=["ref", "port"])
def test_prometheus_parses_back_to_the_snapshot(tel_mod):
    reg = _feed(tel_mod, 3)
    snap, parsed = reg.snapshot(), tel_mod.parse_prometheus(reg.prometheus())
    for sid, series in snap.items():
        if series["type"] == "histogram":
            continue
        got, want = parsed[sid], series["value"]
        assert got == want or (math.isnan(got) and math.isnan(want)), sid
    with pytest.raises(ValueError, match="unparseable"):
        tel_mod.parse_prometheus("bad line{")


def test_histogram_edge_errors_and_types_match_reference():
    for mod in (ref_registry, port_registry):
        assert mod.Histogram(()).edges == mod.DEFAULT_TIME_EDGES
        for edges in ((1.0, 1.0), (2.0, 1.0), (1.0, math.inf)):
            with pytest.raises(ValueError, match="strictly increasing"):
                mod.Histogram(edges)
        reg = mod.Registry()
        reg.counter("x_total")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x_total")
        with pytest.raises(ValueError, match="bad metric name"):
            reg.counter("9bad")
        with pytest.raises(ValueError, match="counters only go up"):
            reg.counter("y_total").inc(-1)
    assert port_registry.DEFAULT_TIME_EDGES == ref_registry.DEFAULT_TIME_EDGES
    assert port_registry.FRACTION_EDGES == ref_registry.FRACTION_EDGES
    assert port_registry.EXPORT_QUANTILES == ref_registry.EXPORT_QUANTILES
    for v in (0.0, -3.0, 1e15, 1e16, 0.1, 1 / 3, math.inf, -math.inf,
              math.nan, 2.0 ** -20):
        assert port_registry._format_value(v) == ref_registry._format_value(v)


def test_label_cardinality_guard_matches_reference():
    snaps = []
    for mod in (ref_registry, port_registry):
        reg = mod.Registry(label_cardinality=4)
        for i in range(10):
            reg.counter("calls_total", peer=f"p{i}").inc(i)
        reg.value("calls_total", peer="p99")  # a read consumes nothing
        assert reg.unregister("calls_total", peer="p0")
        assert not reg.unregister("calls_total", peer="p0")
        snaps.append(reg.snapshot())
    assert json.dumps(snaps[0]) == json.dumps(snaps[1])
    assert snaps[1]['calls_total{peer="other"}']["value"] == 39.0
    assert snaps[1]["telemetry_label_overflow_total"]["value"] == 7.0


@pytest.mark.parametrize("seed", [0, 1])
def test_rolling_quantile_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ref = ref_registry.RollingQuantile(window=16)
    port = port_registry.RollingQuantile(window=16)
    assert ref.quantile(0.5) is None and port.quantile(0.5) is None
    for v in rng.exponential(size=50):
        ref.observe(float(v))
        port.observe(float(v))
        for q in (0.0, *QS, 1.0):
            assert port.quantile(q) == ref.quantile(q)
    port.observe(math.nan)
    assert len(port) == len(ref) == 16
    with pytest.raises(ValueError):
        port.quantile(1.5)
    with pytest.raises(ValueError):
        port_registry.RollingQuantile(0)
    # utils.quantile is the same class, not a second copy.
    assert UtilsRQ is port_registry.RollingQuantile


def _spans(tel_mod):
    tel = tel_mod.Telemetry("peer-a", tracing=True)
    tel.traces = tel_mod.TraceBuffer(
        capacity=5,
        drop_counter=tel.registry.counter("trace_spans_dropped_total"))
    for i in range(7):
        tel.traces.add_span(f"call f{i}", "rpc", ["peer-a", "peer-b"][i % 2],
                            1_000_000 + 10 * (7 - i), 25 * i,
                            trace_id=f"t{i}", tid=i % 3,
                            args={"i": i} if i % 2 else None)
    tel.traces.add_instant("chaos drop", "chaos", "peer-c", ts_us=1_000_005,
                           args={"peer": "x"})
    tel.traces.add_span("neg", "rpc", "peer-a", 999_000, -5)
    return tel


def test_spans_chrome_export_and_drop_count_match_reference():
    ref, port = _spans(ref_tel), _spans(port_tel)
    assert port.traces.dropped == ref.traces.dropped == 4
    assert json.dumps(port.chrome_trace()) == json.dumps(ref.chrome_trace())
    assert port.chrome_trace()["otherData"] == {"spans_dropped": 4}
    assert port.prometheus() == ref.prometheus()
    assert port.registry.value("trace_spans_dropped_total") == 4
    # spans_to_chrome over the other package's spans: one assembly.
    spans = port.traces.spans()
    assert json.dumps(port_tel.spans_to_chrome(spans, dropped=2)) == \
        json.dumps(ref_tel.spans_to_chrome(ref.traces.spans(), dropped=2))
    assert abs(port_tel.now_us() - ref_tel.now_us()) < 10_000_000


@pytest.mark.parametrize("env,on,tracing", [
    ({}, True, False),
    ({"MOOLIB_TPU_TELEMETRY": "0", "MOOLIB_TPU_TRACE": "1"}, False, True),
    ({"MOOLIB_TPU_TELEMETRY": "off", "MOOLIB_TPU_TRACE": "yes"}, False, True),
])
def test_telemetry_switches_read_the_reference_environment(
        monkeypatch, env, on, tracing):
    for k in ("MOOLIB_TPU_TELEMETRY", "MOOLIB_TPU_TRACE",
              "MOOLIB_TPU_FLIGHTREC"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for mod in (ref_tel, port_tel):
        tel = mod.Telemetry("x")
        assert (tel.on, tel.tracing) == (on, tracing)
        assert tel.flight.on
    monkeypatch.setenv("MOOLIB_TPU_FLIGHTREC", "0")
    assert not port_tel.Telemetry("x").flight.on
    tel = port_tel.Telemetry("x", enabled=True, tracing=False)
    tel.set_enabled(False)
    tel.set_tracing(True)
    assert (tel.on, tel.tracing) == (False, True)


def test_global_telemetry_and_publish_metrics_match_reference():
    assert port_tel.global_telemetry() is port_tel.global_telemetry()
    assert port_tel.global_telemetry().name == "global"
    assert sorted(port_tel.__all__) == sorted(ref_tel.__all__)
    row = {"sps": 123.5, "loss/total": 0.25, "done": True, "name": "x",
           "steps": np.int64(7)}
    snaps = []
    for mod in (ref_tel, port_tel):
        reg = mod.Registry()
        mod.publish_metrics(row, prefix="train", registry=reg, run="a")
        snaps.append(reg.prometheus())
    assert snaps[0] == snaps[1]
    assert 'train_loss_total{run="a"} 0.25' in snaps[1]


def test_logging_knobs_match_reference():
    import logging

    for mod in (ref_logging, port_logging):
        with pytest.raises(ValueError, match="unknown log level"):
            mod.set_log_level("loud")
    logger = port_logging.get_logger()
    prev = (logger.level, logger.propagate)
    try:
        port_logging.set_log_level("error")
        assert logger.level == logging.ERROR
        port_logging.set_logging(False)
        assert not logger.propagate
        assert port_logging.get_logger("flightrec").name == \
            "moolib_tpu_torch.flightrec"
    finally:
        logger.setLevel(prev[0])
        logger.propagate = prev[1]


def test_bench_result_rows_cross_parse():
    kw = dict(metric="stepscope_x_host_blocked_fraction", value=0.25,
              unit="fraction", direction="lower", suite="stepscope",
              smoke=True, cmd="c", tol=0.5, extra={"loop": "x"})
    port_row = port_harness.BenchResult(**kw)
    ref_row = ref_harness.BenchResult(**kw)
    assert port_harness.SCHEMA_VERSION == ref_harness.SCHEMA_VERSION
    assert ref_harness.parse_result(port_row.to_json()) == \
        ref_harness.BenchResult(**port_row.to_row())
    assert port_harness.parse_result(ref_row.to_json()).to_row() == \
        ref_row.to_row()
    env = port_row.env
    assert "torch" in env and "jax" not in env
    with pytest.raises(ValueError, match="non-finite"):
        port_harness.BenchResult(metric="m", value=math.nan, unit="u")
    with pytest.raises(ValueError, match="unknown result fields"):
        port_harness.parse_result({**port_row.to_row(), "zzz": 1})
