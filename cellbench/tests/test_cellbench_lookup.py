"""Every part of a cell is found by its name, from files of its own; a
new configuration, mix or metric is new files, and every name and unit
keeps to the characters the benchmark allows."""

import json
import re
import shutil

import pytest

from cellbench import lookup

ROOT = lookup.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_benchmark_has_exactly_its_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cellbench/run.py"]
    assert BENCH["paths"] == ["cellbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", WORKLOADS)
def test_each_cell_finds_its_parts_by_name(name):
    cell = lookup.Cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["loop"] == "learn"
    assert cell.limits, "every cell has its limits file"
    assert cell.loop().__name__.endswith("learn")
    assert cell.family().build
    for m in cell.end_to_end + cell.per_layer:
        assert callable(lookup.reader(m["name"]))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def _names():
    yield from (w["name"] for w in BENCH["workloads"])
    yield from (c["name"] for c in BENCH["configs"])
    yield from (m["name"] for m in METRICS)
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_keep_to_the_allowed_characters(name):
    assert lookup.NAME.match(name)


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entries_keep_to_the_format(metric):
    assert lookup.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    if metric in BENCH["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["moves"] in e2e
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
        assert set(metric["workloads"]) <= set(WORKLOADS)
    else:
        assert metric["source"] in ("device_trace", "host_clock")
        assert 0.01 <= metric["bound"] <= 0.25
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_configs_files_lie_under_paths_and_each_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("cellbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]


def test_whys_and_sources_are_one_short_line():
    for entry in BENCH["configs"] + BENCH["workloads"]:
        for key in ("why", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200
                assert not re.search(r"[\t\n]", entry[key])


def test_a_new_config_mix_and_metric_are_found_from_new_files(tmp_path):
    """Copy the benchmark, add a throwaway configuration, mix, limits and
    per-layer metric as new files and entries, and look them up; no file
    that was there is edited."""
    root = tmp_path / "repo"
    shutil.copytree(ROOT / "cellbench", root / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "cellbench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "cellbench/configs/impala_deep.json").read_text())
    cfg["name"] = "impala_wide_x"
    (root / "cellbench/configs/impala_wide_x.json").write_text(json.dumps(cfg))
    mix = json.loads(
        (ROOT / "cellbench/traffic/impala_learn_b256.json").read_text())
    mix["batch"] = 7
    (root / "cellbench/traffic/mix_x.json").write_text(json.dumps(mix))
    (root / "cellbench/limits/cell_x.json").write_text(
        json.dumps({"nonfinite_losses": {"limit": 0}}))
    (root / "cellbench/metrics/probe_x.py").write_text(
        "def read(r):\n    return 42.0\n")
    bench["configs"].append({"name": "impala_wide_x", "source": "x",
                             "file": "cellbench/configs/impala_wide_x.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "cell_x", "config": "impala_wide_x",
                               "traffic": "mix_x", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "probe_x", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "device",
                               "moves": "learn_env_steps_per_s",
                               "workloads": ["cell_x"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = lookup.Cell("cell_x", root=root, bench_dir=root / "cellbench")
    assert cell.traffic["batch"] == 7
    assert cell.config["name"] == "impala_wide_x"
    assert cell.limits == {"nonfinite_losses": {"limit": 0}}
    assert [m["name"] for m in cell.per_layer if m["name"] == "probe_x"]
    # The old cells do not see the new metric.
    old = lookup.Cell("impala_learn_b256", root=root,
                      bench_dir=root / "cellbench")
    assert "probe_x" not in [m["name"] for m in old.per_layer]
    spec_reader = lookup.load_file_module(
        root / "cellbench/metrics/probe_x.py", "metrics", "probe_x")
    assert spec_reader.read(None) == 42.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        lookup.Cell("no_such_cell")
    with pytest.raises(ValueError):
        lookup.check_name("a b")
