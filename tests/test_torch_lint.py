"""The port's lint engine and its five copied rule families (async,
bench, lifecycle, protocol, wire) held to the reference's: the planted
sources of the reference's own lint tests (``tests/test_lint.py``,
read here as data) go through ``moolib_tpu.analysis`` and
``moolib_tpu_torch.analysis`` and must give the same ``(rule, line, col,
message)`` lists — exactly. Then the engine's baseline, cache and
endpoint layers, the moolint CLI of the port (exit codes, formats,
``--explain``, ``--diff``), and the pins on the public surface."""

import ast
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import pytest

import moolib_tpu.analysis as ref
import moolib_tpu_torch.analysis as port
from moolib_tpu_torch.analysis import engine

REPO_ROOT = Path(__file__).resolve().parent.parent
REF_TESTS = REPO_ROOT / "tests" / "test_lint.py"
BASELINE = REPO_ROOT / "moolib_tpu_torch" / "analysis" / "baseline.json"
BASELINE_TOOLS = REPO_ROOT / "moolib_tpu_torch" / "analysis" / \
    "baseline_tools.json"
MOOLINT = [sys.executable, "-m", "moolib_tpu_torch.tools.moolint"]

#: The copied families' modules and their rule names.
_COPIED = ("rules_async", "rules_bench", "rules_lifecycle",
           "rules_protocol", "rules_wire")
COPIED_RULES = sorted(
    cls.name for mod in _COPIED
    for cls in __import__(f"moolib_tpu_torch.analysis.{mod}",
                          fromlist=["RULES"]).RULES)

#: The reference tests whose planted sources exercise those families.
_CORPUS_TESTS = (
    "test_swallow_", "test_async_", "test_lock_", "test_unawaited_",
    "test_awaited_", "test_dropped_", "test_consumed_", "test_counter_",
    "test_inflight_", "test_gate_", "test_defensive_",
    "test_nested_callback_", "test_rpc_", "test_wire_rule_", "test_bench_",
    "test_life_", "test_line_suppression_comment", "test_file_suppression",
    "test_baseline_roundtrip", "test_baseline_file_roundtrip",
    "test_cli_seeded",
)

#: The reference's jit spelling -> the port's captured region (the wire
#: family's tracer leg reads the port's rules_jax regions). Same lines.
_TO_TORCH = (("import jax\n", "import torch\n"),
             ("@jax.jit\n", "@torch.compile\n"),
             ("jax.jit(", "torch.compile("))


def _corpus():
    """(id, source) for every planted source in the reference's tests of
    the copied families: each multi-line string literal that parses as a
    module with code in it."""
    tree = ast.parse(REF_TESTS.read_text())
    out = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith(_CORPUS_TESTS)):
            continue
        k = 0
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str) and "\n" in node.value):
                continue
            src = textwrap.dedent(node.value)
            try:
                body = ast.parse(src).body
            except SyntaxError:
                continue
            if not body or (len(body) == 1 and isinstance(body[0], ast.Expr)
                            and isinstance(body[0].value, ast.Constant)):
                continue  # a docstring, not a planted source
            out.append(pytest.param(src, id=f"{fn.name[5:]}-{k}"))
            k += 1
    return out


def _port_source(src: str) -> str:
    for a, b in _TO_TORCH:
        src = src.replace(a, b)
    return src


def _port_path(relpath: str) -> str:
    if relpath.startswith("moolib_tpu/"):
        return "moolib_tpu_torch/" + relpath[len("moolib_tpu/"):]
    return relpath


def _key(findings):
    return [(f.rule, f.line, f.col, f.message) for f in findings]


CORPUS = _corpus()


def test_the_corpus_covers_every_copied_rule():
    """The extraction found the reference's planted sources (a change to
    the reference's test layout must not silently empty the corpus), and
    between them they make every copied rule fire."""
    assert len(CORPUS) >= 80, len(CORPUS)
    fired = set()
    for case in CORPUS:
        src = case.values[0]
        for rel in ("scratch.py", "tools/fake_bench.py"):
            fired |= {f.rule for f in ref.lint_source(src, rel,
                                                      only=COPIED_RULES)}
    assert fired == set(COPIED_RULES), sorted(set(COPIED_RULES) - fired)


@pytest.mark.parametrize("relpath", ["scratch.py", "tools/fake_bench.py"])
@pytest.mark.parametrize("src", CORPUS)
def test_copied_families_find_what_the_reference_finds(src, relpath):
    want = ref.lint_source(src, relpath, only=COPIED_RULES)
    got = port.lint_source(_port_source(src), _port_path(relpath),
                           only=COPIED_RULES)
    assert _key(got) == _key(want)


_DEEP = ["def go(rpc):", "    rpc.define_queue('u')"]
for _i in range(25):
    _DEEP.append("    " * (_i + 1) + "while True:")
_DEEP.append("    " * 26 + "f = rpc.async_('p', 'u', 1)")
_DEEP.append("    " * 26 + "f.result()")


@pytest.mark.parametrize("relpath, src", [
    # bench-wallclock's scope, under each package's own paths
    *[(rel, "import time\ndef run():\n    t0 = time.time()\n"
            "    return time.time() - t0\n")
      for rel in ("moolib_tpu/rpc/rpc.py", "tests/test_x.py",
                  "moolib_tpu/examples/bench_x.py", "bench.py",
                  "tools/envpool_bench.py", "moolib_tpu/bench/suite.py",
                  "moolib_tpu/utils/benchmark.py")],
    # the wire family's back-edge replay at 25 nested loops
    ("scratch.py", "\n".join(_DEEP) + "\n"),
], ids=lambda v: v if isinstance(v, str) and "\n" not in v else None)
def test_scoped_and_generated_cases_match_the_reference(relpath, src):
    want = ref.lint_source(src, relpath, only=COPIED_RULES)
    got = port.lint_source(src, _port_path(relpath), only=COPIED_RULES)
    assert _key(got) == _key(want)


def test_bench_scope_covers_the_ports_measurement_trees():
    src = ("import time\ndef run():\n    t0 = time.time()\n"
           "    return time.time() - t0\n")
    for rel in ("moolib_tpu_torch/bench/suite.py",
                "moolib_tpu_torch/tools/perf.py",
                "moolib_tpu_torch/utils/benchmark.py", "bench_torch.py"):
        assert port.lint_source(src, rel, only=["bench-wallclock"]), rel
    for rel in ("moolib_tpu_torch/rpc/rpc.py",
                "moolib_tpu_torch/examples/bench_x.py", "tests/test_x.py"):
        assert port.lint_source(src, rel, only=["bench-wallclock"]) == [], rel


def _wire_tree(root: Path) -> Path:
    """The reference test's two-module wire fixture (test_lint.py,
    test_wire_cross_module_endpoint_resolution)."""
    pkg = root / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "server.py").write_text(textwrap.dedent(
        """
        class Server:
            def __init__(self, rpc, name):
                self.rpc = rpc
                rpc.define(f"{name}::go", self._go)

            def _go(self, a, b):
                return a + b

            def close(self):
                if self._closed:
                    return
                self._closed = True
                self.rpc.undefine("svc::go")
        """
    ))
    (pkg / "client.py").write_text(textwrap.dedent(
        """
        def call(rpc):
            return rpc.async_("peer", "svc::go", 1, 2).result(5.0)

        def typo(rpc):
            return rpc.async_("peer", "svc::goo", 1, 2).result(5.0)

        def skew(rpc):
            return rpc.async_("peer", "svc::go", 1, 2, 3).result(5.0)
        """
    ))
    return pkg


def test_cross_module_wire_findings_match_the_reference(tmp_path):
    pkg = _wire_tree(tmp_path)
    want = ref.lint_paths([pkg], root=tmp_path, only=COPIED_RULES)
    got = port.lint_paths([pkg], root=tmp_path, only=COPIED_RULES)
    assert [f.path for f in got] == [f.path for f in want]
    assert _key(got) == _key(want)
    assert sorted(f.rule for f in got) == ["rpc-endpoint-arity",
                                           "rpc-endpoint-unknown"]


def test_out_of_run_endpoints_are_the_ports_own():
    """The wire family's out-of-run patterns (the telemetry and flight
    recorder surface, the serving ``{service}.*``, ``StateStoreService::*``
    and ``fleet.*`` families) are each defined somewhere in the port's
    own tree, and the port's call sites into them all resolve."""
    from moolib_tpu_torch.analysis.rules_wire import _BUILTIN_ENDPOINTS

    trees = [REPO_ROOT / "moolib_tpu_torch" / d
             for d in ("rpc", "serving", "statestore", "fleet", "telemetry",
                       "flightrec")]
    contexts = [engine.ModuleContext(p.read_text(),
                                     p.relative_to(REPO_ROOT).as_posix())
                for p in engine.iter_py_files(trees)]
    index = engine.ProjectIndex(contexts)
    defined = [ep.pattern for ep in index.endpoints()]
    for pattern in _BUILTIN_ENDPOINTS:
        assert any(engine.patterns_overlap(pattern, d) for d in defined), \
            engine.pattern_display(pattern)
    findings = port.lint_paths(trees, root=REPO_ROOT,
                               only=["rpc-endpoint-unknown",
                                     "rpc-endpoint-arity"])
    assert findings == [], "\n".join(map(str, findings))


# -- baseline and cache -------------------------------------------------------


_BLOCKING = ("import asyncio\nimport time\n\n"
             "async def f():\n    time.sleep(1)\n")


def test_baseline_round_trip_matches_the_reference(tmp_path):
    src = _BLOCKING + "\nasync def g(fut):\n    fut.result()\n"
    findings = port.lint_source(src, "scratch.py")
    assert [f.rule for f in findings] == ["async-blocking-call"] * 2
    assert port.findings_to_baseline(findings) == \
        ref.findings_to_baseline(ref.lint_source(src, "scratch.py"))
    path = tmp_path / "baseline.json"
    port.save_baseline(path, findings)
    reloaded = port.load_baseline(path)
    assert reloaded == port.findings_to_baseline(findings)
    assert port.diff_against_baseline(findings, reloaded) == ([], [])
    ref_path = tmp_path / "ref.json"
    ref.save_baseline(ref_path, ref.lint_source(src, "scratch.py"))
    assert path.read_bytes() == ref_path.read_bytes()
    # A second, distinct violation is new with the first grandfathered.
    first = port.findings_to_baseline(port.lint_source(_BLOCKING,
                                                       "scratch.py"))
    new, fixed = port.diff_against_baseline(findings, first)
    assert [f.snippet for f in new] == ["fut.result()"] and fixed == []
    # And an entry the tree no longer has is reported fixed.
    new, fixed = port.diff_against_baseline([], first)
    assert new == [] and [e["count"] for e in fixed] == [1]


def test_baseline_identity_survives_line_shifts():
    baseline = port.findings_to_baseline(port.lint_source(_BLOCKING, "m.py"))
    shifted = port.lint_source("# a new leading comment\n\n\n" + _BLOCKING,
                               "m.py")
    assert port.diff_against_baseline(shifted, baseline) == ([], [])
    with pytest.raises(port.LintError):
        bad = Path(tempfile.mkdtemp()) / "b.json"
        bad.write_text('{"version": 99}')
        port.load_baseline(bad)


def test_cache_hits_misses_and_invalidates_on_content(tmp_path):
    """The same run sequence through both packages' engines gives the
    same hit/miss counts and findings."""
    for pkg, sub in ((ref, "ref"), (port, "port")):
        d = tmp_path / sub
        d.mkdir()
        f = d / "m.py"
        f.write_text(_BLOCKING)
        cache = d / "cache.json"
        runs = []
        for edit in (None, None, "\nx = 1\n"):
            if edit:
                f.write_text(f.read_text() + edit)
            stats = {}
            found = pkg.lint_paths([f], root=d, cache_path=cache,
                                   cache_stats=stats)
            runs.append((stats, [x.to_dict() for x in found]))
        assert [r[0] for r in runs] == [{"hits": 0, "misses": 1},
                                        {"hits": 1, "misses": 0},
                                        {"hits": 0, "misses": 1}], sub
        assert runs[0][1] == runs[1][1] == runs[2][1] != []


def test_corrupt_cache_file_is_ignored(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("x = 1\n")
    cache = tmp_path / "cache.json"
    cache.write_text("{not json")
    stats = {}
    port.lint_paths([f], root=tmp_path, cache_path=cache, cache_stats=stats)
    assert stats == {"hits": 0, "misses": 1}
    stats = {}
    port.lint_paths([f], root=tmp_path, cache_path=cache, cache_stats=stats)
    assert stats == {"hits": 1, "misses": 0}


def test_default_cache_sits_beside_the_ports_baselines():
    assert engine.DEFAULT_CACHE == BASELINE.parent / "lint_cache.json"
    ignored = (REPO_ROOT / ".gitignore").read_text().splitlines()
    assert "moolib_tpu_torch/analysis/lint_cache.json" in ignored


def test_hidden_ancestor_scanned_dot_subdirs_skipped(tmp_path):
    root = tmp_path / ".ci-workspace" / "pkg"
    (root / ".git").mkdir(parents=True)
    (root / "m.py").write_text(_BLOCKING)
    (root / ".git" / "hook.py").write_text(_BLOCKING)
    findings = port.lint_paths([root], root=tmp_path)
    assert [f.rule for f in findings] == ["async-blocking-call"]
    assert engine.list_lint_files([root], root=tmp_path) == [
        ".ci-workspace/pkg/m.py"]


# -- the CLI ------------------------------------------------------------------


def _cli(*args, timeout=300):
    return subprocess.run([*MOOLINT, *map(str, args)], capture_output=True,
                          text=True, cwd=str(REPO_ROOT), timeout=timeout)


@pytest.fixture
def seeded(tmp_path):
    bad = tmp_path / "scratch.py"
    bad.write_text(_BLOCKING)
    return bad


def test_cli_exit_codes(seeded, tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    proc = _cli("--no-cache", clean)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout
    proc = _cli("--check", "--no-cache", seeded)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "async-blocking-call" in proc.stdout
    proc = _cli("--json", "--no-cache", seeded)
    assert proc.returncode == 1
    assert [f["rule"] for f in json.loads(proc.stdout)["new"]] == [
        "async-blocking-call"]
    for bad_args in (["--only", "no-such-rule", seeded],
                     [tmp_path / "missing.py"],
                     ["--json", "--format=gha", seeded],
                     ["--baseline-stats", "tests/"]):
        proc = _cli(*bad_args)
        assert proc.returncode == 2, (bad_args, proc.stdout, proc.stderr)


def test_cli_gha_format_annotations(seeded):
    proc = _cli("--format=gha", "--no-cache", seeded)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    lines = [l for l in proc.stdout.splitlines() if l.startswith("::error ")]
    assert len(lines) == 1
    assert "line=5," in lines[0] and "col=5," in lines[0]
    assert "title=moolint::async-blocking-call" in lines[0]


def test_cli_baseline_update_and_stats(seeded, tmp_path):
    base = tmp_path / "base.json"
    proc = _cli("--baseline", base, "--baseline-update", "--no-cache",
                seeded)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = _cli("--baseline", base, "--no-cache", seeded)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "1 baselined" in proc.stdout
    proc = _cli("--baseline", base, "--baseline-stats", "--json")
    data = json.loads(proc.stdout)
    assert proc.returncode == 0
    assert data["total"] == 1
    assert data["per_rule"] == {"async-blocking-call": 1}
    proc = _cli("--baseline", base, "--baseline-stats", "--fail-nonempty")
    assert proc.returncode == 1
    assert "must stay empty" in proc.stderr


def test_cli_rule_times_and_cache_line(tmp_path):
    scratch = tmp_path / "scratch.py"
    scratch.write_text("x = 1\n")
    proc = _cli("--rule-times", "--no-baseline", "--no-cache", scratch)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "per-rule wall-time" in proc.stdout
    assert "moolint: cache:" not in proc.stdout
    proc = _cli("--baseline-stats", "--rule-times", "--json", "--only",
                "race-*")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert set(json.loads(proc.stdout)["rule_seconds"]) == {
        "race-bare-suppression", "race-unguarded-field",
        "race-nonatomic-rmw", "race-lock-gap", "race-lock-order-cycle"}


def test_cli_explain_registered_and_not_ported_rules():
    proc = _cli("--explain", "async-blocking-call")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("async-blocking-call\n")
    assert "suppression: # moolint: disable=async-blocking-call" in \
        proc.stdout
    proc = _cli("--explain", "num-*,jit-missing-*", "--json")
    assert proc.returncode == 0, proc.stderr
    rows = {r["name"]: r for r in json.loads(proc.stdout)}
    assert set(rows) == {
        "prng-key-reuse", "unseeded-randomness", "lowprec-accumulate",
        "implicit-dtype-promotion", "nondet-iteration-to-tensor",
        "num-bare-suppression", "jit-missing-static",
        "jit-missing-donation"}
    assert rows["jit-missing-static"]["not_ported"] == \
        port.not_ported_rules()["jit-missing-static"]
    assert rows["prng-key-reuse"]["suppression"].startswith(
        "# numlint: prng-key-reuse -- <reason>")
    proc = _cli("--explain", "no-such-rule")
    assert proc.returncode == 2
    assert "unknown rule" in proc.stderr


def test_cli_list_rules_names_every_reference_rule():
    proc = _cli("--list-rules", "--json")
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(proc.stdout)
    names = {r["name"] for r in rows}
    assert names == {r.name for r in ref.all_rules()}
    not_ported = {r["name"]: r["not_ported"] for r in rows
                  if "not_ported" in r}
    assert not_ported == port.not_ported_rules()
    text = _cli("--list-rules").stdout
    for name in not_ported:
        assert f"{name}  [not ported]" in text


def test_cli_diff_mode():
    """--diff REF lints only files changed vs the ref: an untracked
    seeded file is picked up; paths with no changed lintable files exit
    0 with a note; a bad ref exits 2; --baseline-update is refused."""
    scratch = REPO_ROOT / "tests" / "_torch_moolint_diff_scratch_tmp.py"
    scratch.write_text(_BLOCKING)
    try:
        proc = _cli("--diff", "HEAD", "--no-baseline", "--no-cache", scratch)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "async-blocking-call" in proc.stdout
    finally:
        scratch.unlink()
    empty = tempfile.mkdtemp(dir=str(REPO_ROOT / "tests"))
    try:
        proc = _cli("--diff", "HEAD", empty)
    finally:
        os.rmdir(empty)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "no changed lintable files" in proc.stdout
    proc = _cli("--diff", "no-such-ref-xyz")
    assert proc.returncode == 2
    assert "no-such-ref-xyz" in proc.stderr
    proc = _cli("--diff", "HEAD", "--baseline-update")
    assert proc.returncode == 2
    assert "conflicts" in proc.stderr


# -- the public surface ---------------------------------------------------------


#: The reference rules that may have no torch counterpart.
_MAY_BE_UNPORTED = {"jit-missing-donation", "donated-buffer-reuse",
                    "pallas-blockspec-static", "jit-missing-static",
                    "prng-key-reuse"}


def test_analysis_exports_every_name_of_the_reference():
    assert set(ref.__all__) <= set(port.__all__)
    for name in ref.__all__:
        assert getattr(port, name) is not None, name
    assert set(ref.engine.__all__) <= set(engine.__all__)


def test_every_reference_rule_is_ported_or_has_a_reason():
    ported = {r.name for r in port.all_rules()}
    missing = port.not_ported_rules()
    for r in ref.all_rules():
        assert (r.name in ported) != (r.name in missing), r.name
    assert set(missing) <= _MAY_BE_UNPORTED
    assert all(len(why) > 40 for why in missing.values()), missing
    assert len(ported) + len(missing) == len(ref.all_rules()) == 44
    # Families and suppression grammars carried over with the names.
    ref_rules = {r.name: r for r in ref.all_rules()}
    for r in port.all_rules():
        assert r.family == ref_rules[r.name].family, r.name
        assert r.suppression_grammar() == \
            ref_rules[r.name].suppression_grammar(), r.name


def test_both_baselines_ship_empty():
    for path in (BASELINE, BASELINE_TOOLS):
        assert port.load_baseline(path)["findings"] == [], path
