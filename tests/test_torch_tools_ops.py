"""The operator plane of the port against the reference: the launcher and
the plotter (``examples/launch.py``, ``examples/plot.py``) and the ten
tools without a twin before (``moolib_tpu_torch/tools/``), on the CPU at
small sizes. Every output goes under ``tmp_path``; nothing dials an
outside host (the package-index probe is held to loopback sockets)."""

import importlib.util
import json
import math
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from moolib_tpu.examples import launch as ref_launch
from moolib_tpu.examples import plot as ref_plot
from moolib_tpu_torch.examples import launch, plot

REPO_ROOT = Path(__file__).resolve().parent.parent


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_tool_{name}", REPO_ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args, timeout, cwd=REPO_ROOT):
    return subprocess.run(
        [sys.executable, *args], cwd=str(cwd), capture_output=True,
        text=True, timeout=timeout,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )


# -- plot ---------------------------------------------------------------------


def _write_logs(path, seed):
    rng = np.random.default_rng(seed)
    steps = np.cumsum(rng.integers(100, 300, size=40))
    returns = rng.normal(20.0, 8.0, size=40)
    returns[[3, 17]] = np.nan  # an empty window logs NaN
    with open(path, "w") as f:
        f.write("env_steps\tepisode_returns\tleader\ttotal_loss\n")
        for s, r in zip(steps, returns):
            f.write(f"{s}\t{r:.4f}\t{rng.random() < 0.5}\t"
                    f"{rng.normal():.6f}\n")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("y", ["episode_returns", "total_loss", "leader"])
def test_plot_renders_byte_identical_to_the_reference(tmp_path, seed, y):
    path = tmp_path / "logs.tsv"
    _write_logs(path, seed)
    rows = plot.read_tsv(str(path))
    assert repr(rows) == repr(ref_plot.read_tsv(str(path)))  # NaN cells
    pts = [(r.get("env_steps"), r.get(y)) for r in rows]
    for width, height in ((100, 24), (37, 9)):
        got = plot.render(pts, width, height, "env_steps", y)
        assert got.encode() == ref_plot.render(
            pts, width, height, "env_steps", y).encode()
    assert plot.render([]) == ref_plot.render([])


def test_plot_cli_prints_what_the_reference_prints(tmp_path):
    _write_logs(tmp_path / "logs.tsv", 5)
    ports = _run(["-m", "moolib_tpu_torch.examples.plot", str(tmp_path),
                  "--width", "60", "--height", "12"], 60)
    refs = _run(["-m", "moolib_tpu.examples.plot", str(tmp_path),
                 "--width", "60", "--height", "12"], 60)
    assert ports.returncode == refs.returncode == 0, ports.stderr
    assert ports.stdout == refs.stdout and "points]" in ports.stdout


# -- launch -------------------------------------------------------------------


def test_write_sbatch_equals_the_reference_but_the_module(tmp_path):
    args = (8, "tcp://head:4431", "/shared/run1",
            ["env=synthetic", "total_steps=10"])
    port = Path(launch.write_sbatch(str(tmp_path / "p.sbatch"), *args,
                                    cpus=6))
    ref = Path(ref_launch.write_sbatch(str(tmp_path / "r.sbatch"), *args,
                                       cpus=6))
    assert port.read_text() == ref.read_text().replace(
        "moolib_tpu.examples", "moolib_tpu_torch.examples")
    assert "-m moolib_tpu_torch.examples.vtrace.experiment" \
        in port.read_text()
    assert os.access(port, os.X_OK)


def test_launch_local_runs_two_cpu_peers_to_their_end(tmp_path):
    """``launch local`` starts the port's broker and two CartPole peers;
    ``--device cpu`` reaches the children through ``--`` and both exit
    0 with updates in one group, each printing its kernel launches."""
    proc = _run(["-m", "moolib_tpu_torch.examples.launch", "local",
                 "--peers", "2", "--savedir", str(tmp_path), "--",
                 "env=cartpole", "--device", "cpu", "max_seconds=6",
                 "actor_batch_size=8", "learn_batch_size=8",
                 "virtual_batch_size=16", "num_actor_processes=1",
                 "unroll_length=5", "log_interval_steps=200"], 240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[broker] moolib_tpu broker listening on" in proc.stdout
    done = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith('{"updates"')]
    assert len(done) == 2
    for d in done:
        assert d["updates"] > 0
        assert set(d["kernel_launches"]) == {
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv", "flash_bwd_tile"}
    groups = set()
    for i in range(2):
        rows = plot.read_tsv(str(tmp_path / f"peer{i}" / "logs.tsv"))
        assert rows and rows[-1]["env_steps"] > 0
        meta = json.loads((tmp_path / f"peer{i}" / "metadata.json")
                          .read_text())
        groups.add(meta["config"]["group"])
    assert groups == {"vtrace"}


def test_a_peers_report_line_is_one_write(monkeypatch):
    """The report line a launcher reads leaves in one write, newline
    included: the peers share the launcher's stdout, and on an
    unbuffered stream print() writes a line and its newline apart, so
    another peer's line can land between them (on the card, a report
    line with a second peer's JSON glued to its end)."""
    from moolib_tpu_torch.examples.vtrace import experiment

    writes = []

    class Stream:
        def write(self, s):
            writes.append(s)
            return len(s)

        def flush(self):
            pass

    monkeypatch.setattr(experiment, "train",
                        lambda cfg, device=None: [{"updates": 7}])
    monkeypatch.setattr(sys, "argv", ["experiment", "--device", "cpu"])
    monkeypatch.setattr(sys, "stdout", Stream())
    experiment.main()
    reports = [w for w in writes if w.startswith('{"updates"')]
    assert len(reports) == 1 and reports[0].endswith("}\n"), writes
    assert json.loads(reports[0])["updates"] == 7


def test_launch_local_returns_a_peers_error_without_a_card(tmp_path):
    """Without ``--device cpu`` a peer resolves the card, raises, and
    the launcher returns its exit code, as the reference's does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the peer would train on it")
    rc = launch.launch_local(1, ["env=cartpole", "total_steps=100"],
                             savedir=str(tmp_path))
    assert rc != 0


# -- learning_curve, env_packages_report ---------------------------------------


def test_learning_curve_writes_the_references_artifact_keys(tmp_path):
    out = tmp_path / "curve.json"
    proc = _run(["-m", "moolib_tpu_torch.tools.learning_curve",
                 "--steps", "4500", "--device", "cpu", "--json", str(out)],
                240)
    # The bar cannot be met in 4500 steps: exit 1, artifact written.
    assert proc.returncode == 1, proc.stderr[-3000:]
    art = json.loads(out.read_text())
    ref = json.loads((REPO_ROOT / "LEARNING_r04.json").read_text())
    assert set(art) == set(ref) | {"device"}
    assert art["passed"] is False and art["device"] == "cpu"
    assert set(art["curve"][0]) == set(ref["curve"][0])
    assert art["curve"][-1]["env_steps"] >= 4000
    assert json.loads(proc.stdout.strip().splitlines()[-1])["total_steps"] \
        == 4500


def test_learning_curve_never_writes_a_root_file_by_default():
    from moolib_tpu_torch.tools import learning_curve

    assert Path(learning_curve.DEFAULT_JSON).parent == REPO_ROOT / "build"


def test_env_packages_report_has_the_references_keys(tmp_path):
    from moolib_tpu_torch.tools import env_packages_report as epr

    out = tmp_path / "envs.json"
    assert epr.main(["--json", str(out)]) == 0
    art = json.loads(out.read_text())
    ref = json.loads((REPO_ROOT / "ENVS_r05.json").read_text())
    assert set(art) == set(ref)
    assert set(art["packages"]) == set(ref["packages"]) == set(epr.WANTED)
    for name, probe in art["packages"].items():
        assert probe["installed"] is (importlib.util.find_spec(name)
                                      is not None), name
    # Not asked: the index probe dials nothing.
    assert art["pypi_probe"]["reachable"] is None


def test_env_packages_index_probe_on_loopback_only():
    from moolib_tpu_torch.tools import env_packages_report as epr

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    try:
        up = epr.probe_index("127.0.0.1", port, timeout=2.0)
        assert up["reachable"] is True and up["connect_s"] >= 0
        art = epr.report(f"127.0.0.1:{port}")
        assert art["pypi_probe"]["reachable"] is True
    finally:
        srv.close()
    down = epr.probe_index("127.0.0.1", port, timeout=2.0)
    assert down["reachable"] is False and "Error" in down["error"]


# -- config_matrix, elastic_soak -----------------------------------------------


# Config 1's ImpalaNet reaches its first update on this CPU after ~2 s of
# acting alone; 8 s leaves room for a loaded host.
@pytest.mark.parametrize("config,seconds", [(1, 8), (3, 2)])
def test_config_matrix_config_trains_on_the_cpu(tmp_path, config, seconds):
    out = tmp_path / "configs.json"
    proc = _run(["-m", "moolib_tpu_torch.tools.config_matrix",
                 "--seconds", str(seconds), "--device", "cpu", "--only",
                 str(config), "--json", str(out)], 300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    art = json.loads(out.read_text())
    ref = json.loads((REPO_ROOT / "CONFIGS_r04.json").read_text())
    assert set(art) == set(ref) | {"device"}
    res = art["configs"][str(config)]
    assert res["ok"], res
    peers = res["peers"].values() if config == 3 else [res]
    for p in peers:
        assert p["env_steps"] > 0 and p["updates"] > 0
        assert math.isfinite(p["total_loss"])
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "all_ok": True, "failed": []}


def test_elastic_soak_survives_churn_on_the_cpu(tmp_path):
    out = tmp_path / "soak.json"
    proc = _run(["-m", "moolib_tpu_torch.tools.elastic_soak",
                 "--minutes", "0.25", "--peers", "2", "--kill-interval",
                 "6", "--device", "cpu", "--json", str(out),
                 "--workdir", str(tmp_path / "peers")], 300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    art = json.loads(out.read_text())
    ref = json.loads((REPO_ROOT / "SOAK_r04.json").read_text())
    assert set(ref) <= set(art)
    assert art["ok"] and art["fail_reason"] is None
    assert art["kills"] >= 1 and art["peak_live_updates_sum"] > 0
    assert len(art["churn_history"]) == art["kills"]


# -- allreduce_decomp, allreduce_latency_ab -------------------------------------


@pytest.mark.parametrize("peers,mb,chunk", [(4, 32.0, 8 << 20),
                                            (2, 1.0, 1 << 20),
                                            (7, 33.55, 4 << 20)])
def test_tree_roofline_is_the_references_exactly(peers, mb, chunk):
    from moolib_tpu_torch.tools import allreduce_decomp

    ref = _ref_tool("allreduce_decomp")
    prims = {"_sock_s_per_byte": 1.3e-9, "_add_s_per_byte": 2.1e-10,
             "_memcpy_s_per_byte": 7.7e-11}
    nbytes = int(mb * (1 << 20))
    assert allreduce_decomp.tree_roofline(prims, 1.8e-4, nbytes, peers,
                                          chunk) \
        == ref.tree_roofline(prims, 1.8e-4, nbytes, peers, chunk)


def test_allreduce_decomp_reports_the_hosts_cores():
    proc = _run(["-m", "moolib_tpu_torch.tools.allreduce_decomp",
                 "--peers", "2", "--mb", "1", "--skip-measured"], 120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout)
    assert out["cpu_count"] == os.cpu_count()
    assert out["host_primitives"]["nproc"] == os.cpu_count()
    from moolib_tpu_torch.rpc.group import _CHUNK_BYTES

    assert out["chunk_bytes"] == _CHUNK_BYTES
    assert out["rpc_small_call_us"] > 0
    assert set(out["single_core_tree_roofline"]) == {
        "hop_s", "merge_s", "msg_overhead_s", "reassembly_s", "total_s",
        "roofline_gbps"}


def test_latency_ab_has_the_references_keys_and_the_delay_shows():
    from moolib_tpu_torch.tools import allreduce_latency_ab

    nbytes = 1 << 20
    row = allreduce_latency_ab.run_ab(2, nbytes, 100.0, rounds=2)
    ref = _ref_tool("allreduce_latency_ab").run_ab(2, nbytes, 100.0,
                                                   rounds=1)
    assert set(row) == set(ref)
    assert row["injected_wire_s_per_payload"] \
        == ref["injected_wire_s_per_payload"]
    # Two peers: the payload crosses the one link up and back down, each
    # way paying at least the injected wire time.
    assert row["unchunked_s"] >= 2 * row["injected_wire_s_per_payload"]
    assert row["chunked_depth4_s"] >= row["injected_wire_s_per_payload"]


# -- telemetry_dump, incident_report, stepscope_report --------------------------


def _planted_traces():
    def trace(pid, name, events, dropped=None):
        evs = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": name}}] + events
        out = {"traceEvents": evs, "displayTimeUnit": "ms"}
        if dropped is not None:
            out["otherData"] = {"spans_dropped": dropped}
        return out

    shared = {"name": "chaos drop", "ph": "i", "pid": 9, "tid": 1,
              "ts": 50, "s": "t", "cat": "chaos"}
    a = trace(9, "proc", [
        {"name": "call f", "ph": "X", "pid": 9, "tid": 1, "ts": 10,
         "dur": 5, "args": {"trace_id": "t1"}}, dict(shared)], dropped=3)
    b = trace(4, "proc", [dict(shared, pid=4)], dropped=0)
    c = trace(2, "other", [
        {"name": "handle f", "ph": "X", "pid": 2, "tid": 7, "ts": 11,
         "dur": 2, "args": {"trace_id": "t1"}},
        {"name": "orphan", "ph": "X", "pid": 5, "tid": 0, "ts": 1,
         "dur": 1}])
    return [("a", a), ("b", b), ("c", c), ("d", {"traceEvents": []})]


def test_merge_chrome_traces_is_the_references():
    from moolib_tpu_torch.tools import telemetry_dump

    traces = _planted_traces()
    got = telemetry_dump.merge_chrome_traces(json.loads(json.dumps(traces)))
    want = _ref_tool("telemetry_dump").merge_chrome_traces(traces)
    assert json.dumps(got) == json.dumps(want)
    # The shared track's instant appears once; the eviction counts ride.
    assert sum(e["name"] == "chaos drop" for e in got["traceEvents"]) == 1
    assert got["otherData"]["spans_dropped"] == {"a": 3, "b": 0}


def test_incident_report_gives_the_references_timeline(tmp_path):
    """The same planted bundles (clock skew, a handler landing before
    its caller, a shared track) merged offline by both tools: the same
    timeline bytes and report."""
    import moolib_tpu.flightrec as ref_fr
    import moolib_tpu.telemetry as ref_tel
    import moolib_tpu_torch.flightrec as port_fr
    import moolib_tpu_torch.telemetry as port_tel
    from moolib_tpu_torch.tools import incident_report
    from test_torch_flightrec import _pair

    ref_tool = _ref_tool("incident_report")
    outs = {}
    for tag, fr, tel, tool in (("ref", ref_fr, ref_tel, ref_tool),
                               ("port", port_fr, port_tel, incident_report)):
        bundles = _pair(fr, tel)
        for name, b in bundles.items():
            b["peer"] = name
            b["stacks"], b["fingerprint"] = "", {"python": "3", "pid": 1,
                                                 "env": {}}
            b["captured_at_us"] = 0
        src = tmp_path / tag / "in"
        for b in bundles.values():
            fr.write_bundle(b, str(src))
        (src / "offsets.json").write_text(json.dumps({"B": 5_000_000}))
        loaded, offsets, failed = tool.collect_offline(str(src))
        assert not failed and set(loaded) == {"A", "B", "C"}
        report = tool.write_report(str(tmp_path / tag / "out"), loaded,
                                   offsets, {}, {}, failed)
        report.pop("bundles")
        outs[tag] = (
            (tmp_path / tag / "out" / "timeline.jsonl").read_bytes(),
            (tmp_path / tag / "out" / "trace.json").read_bytes(), report)
    assert outs["port"] == outs["ref"]
    timeline = [json.loads(line) for line in outs["port"][0].splitlines()]
    calls = {r["trace_id"]: r["ts_us"] for r in timeline
             if r["type"] == "span" and r["name"].startswith("call ")}
    for r in timeline:
        if r["type"] == "span" and r["name"].startswith("handle "):
            assert r["ts_us"] >= calls[r["trace_id"]]


def test_incident_report_smoke_on_the_cpu():
    from moolib_tpu_torch.tools import incident_report

    assert incident_report.main(["--smoke"]) == 0


def _planted_metrics(tel_mod, seed):
    rng = np.random.default_rng(seed)
    tel = tel_mod.Telemetry(f"ss{seed}", enabled=True)
    for loop, phases in (("vtrace_learner", ("fwd_bwd", "env_wait",
                                             "grad_allreduce")),
                         ("envpool", ("batch_fill",))):
        scope = tel_mod.StepScope(loop, telemetry=tel)
        for _ in range(12):
            split = {p: float(rng.uniform(0.001, 0.01)) for p in phases}
            scope.observe_step(sum(split.values()) * 1.1, split)
        scope.close()
    return tel.registry.snapshot()


def test_stepscope_report_metrics_mode_gives_the_references_summaries(
        tmp_path):
    import moolib_tpu.telemetry as ref_tel
    from moolib_tpu_torch.tools import stepscope_report

    dump = {f"peer{s}": _planted_metrics(ref_tel, s) for s in (0, 1)}
    path = tmp_path / "metrics.json"
    path.write_text(json.dumps(dump))
    ref = _ref_tool("stepscope_report")
    got = stepscope_report.collect_metrics_file(str(path))
    assert got == ref.collect_metrics_file(str(path))
    assert got["peer0"]["vtrace_learner"]["steps"] == 12
    assert stepscope_report.merge_summaries(got) == ref.merge_summaries(got)
    assert stepscope_report.format_summary_table("t", got["peer1"]) \
        == ref.format_summary_table("t", got["peer1"])
    assert stepscope_report.check_ledger_closure(got["peer0"], 0.2) \
        == ref.check_ledger_closure(got["peer0"], 0.2)
    rc = stepscope_report.main(["--metrics", str(path), "--out",
                                str(tmp_path / "rep")])
    assert rc == 0
    rep = json.loads((tmp_path / "rep" / "report.json").read_text())
    assert rep["peers"] == json.loads(json.dumps(got))


def test_crawl_tools_reach_a_live_port_cohort_from_one_address(tmp_path):
    """telemetry_dump (spans, Prometheus, bundles), incident_report and
    stepscope_report --connect against two port peers, dialing one."""
    from moolib_tpu_torch.rpc import Rpc
    from moolib_tpu_torch.telemetry import StepScope, Telemetry
    from moolib_tpu_torch.tools import (incident_report, stepscope_report,
                                        telemetry_dump)

    peers = [Rpc(f"ops-{i}", telemetry=Telemetry(f"ops-{i}", enabled=True,
                                                 tracing=True))
             for i in range(2)]
    scope = StepScope("vtrace_learner", telemetry=peers[0].telemetry)
    try:
        for r in peers:
            r.listen("127.0.0.1:0")
        peers[0].connect(peers[1].debug_info()["listen"][0])
        peers[1].define("echo", lambda x: x)
        for i in range(5):
            assert peers[0].sync("ops-1", "echo", i) == i
        for _ in range(6):
            scope.observe_step(0.01, {"fwd_bwd": 0.006, "env_wait": 0.004})
        addr = peers[0].debug_info()["listen"][0]
        dump = tmp_path / "dump"
        assert telemetry_dump.main(
            ["--connect", addr, "--spans", "--prometheus", "--bundle",
             "--out", str(dump), "--discover-seconds", "3"]) == 0
        metrics = json.loads((dump / "metrics.json").read_text())
        assert set(metrics) == {"ops-0", "ops-1"}
        trace = json.loads((dump / "trace.json").read_text())
        names = {e["name"] for e in trace["traceEvents"]}
        assert "call echo" in names and "handle echo" in names
        assert {p.name for p in dump.glob("*.prom")} == {"ops-0.prom",
                                                         "ops-1.prom"}
        assert len(list((dump / "bundles").glob("*.json"))) == 2
        rep = tmp_path / "incident"
        assert incident_report.main(["--connect", addr, "--out", str(rep),
                                     "--discover-seconds", "3"]) == 0
        report = json.loads((rep / "report.json").read_text())
        assert report["peers"] == ["ops-0", "ops-1"]
        assert stepscope_report.main(
            ["--connect", addr, "--out", str(tmp_path / "ss"),
             "--discover-seconds", "3"]) == 0
        ss = json.loads((tmp_path / "ss" / "report.json").read_text())
        assert ss["peers"]["ops-0"]["vtrace_learner"]["steps"] == 6
        assert stepscope_report.check_ledger_closure(
            ss["peers"]["ops-0"], 0.05) < 1e-9
    finally:
        scope.close()
        for r in peers:
            r.close()


# -- gen_api_docs ----------------------------------------------------------------


def test_gen_api_docs_is_deterministic_and_covers_every_module():
    import pkgutil

    import moolib_tpu_torch
    from moolib_tpu_torch.tools import gen_api_docs

    first = gen_api_docs.generate()
    assert gen_api_docs.generate() == first
    mods = {m.name for m in pkgutil.walk_packages(
        moolib_tpu_torch.__path__, "moolib_tpu_torch.")} | {
        "moolib_tpu_torch"}
    docs = Path(gen_api_docs.DOCS)
    assert docs == REPO_ROOT / "docs" / "torch"
    assert set(first) == {str(docs / "index.md")} | {
        str(docs / "api" / (m.replace(".", "_") + ".md")) for m in mods}
    index = first[str(docs / "index.md")]
    for m in mods:
        assert f"[`{m}`]" in index, m
    assert " at 0x" not in "".join(first.values())


def test_gen_api_docs_committed_tree_is_current():
    """The committed docs/torch/ tree matches the code, in a fresh
    interpreter (the CLI's --check); importing every module for it built
    no kernel."""
    proc = _run(["-c", textwrap.dedent("""
        import sys
        from moolib_tpu_torch.tools import gen_api_docs
        rc = gen_api_docs.main(["--check"])
        from moolib_tpu_torch.ops import _kernels
        print("builds", _kernels.build_count(),
              [lib.builds for lib in _kernels.LIBRARIES])
        sys.exit(rc)
    """)], 180)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "docs up to date" in proc.stdout
    assert "builds 0 [0, 0]" in proc.stdout
