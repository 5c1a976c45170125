"""The port's lint engine, racelint and locktrace against the reference:
the race rules' findings on the reference tests' planted sources, the
static lock edges of one tree computed by both packages, the six
locktrace unit cases of ``tests/test_race.py`` run under each tracer in
turn, and the port's own scenarios and chaos soak under the port's
tracer, within the port's static edges.

The two tracers both patch ``threading.Lock``: they are never active at
once (``_traced`` checks it).
"""

import _thread
import ast
import importlib.util
import json
import queue
import textwrap
import threading
from pathlib import Path

import pytest
import torch

import moolib_tpu.analysis as ref_analysis
import moolib_tpu.testing.locktrace as ref_lt
from moolib_tpu.analysis.rules_race import RULES as REF_RULES
from moolib_tpu.analysis.rules_race import static_lock_edges as ref_edges
import moolib_tpu_torch.analysis as port_analysis
import moolib_tpu_torch.testing.locktrace as port_lt
from moolib_tpu_torch.analysis.rules_race import RULES as PORT_RULES
from moolib_tpu_torch.analysis.rules_race import static_lock_edges

REPO_ROOT = Path(__file__).resolve().parent.parent
TRACERS = [ref_lt, port_lt]

# -- racelint on the reference's planted sources --------------------------------


def _race_sources(test_file, prefix):
    """{test name: [dedented source, ...]} for every test function of
    ``test_file`` named ``prefix*``: its string constants, plus the
    ``name.replace(a, b)`` variants it builds from them."""
    tree = ast.parse((REPO_ROOT / "tests" / test_file).read_text())
    out = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith(prefix)):
            continue
        named, srcs = {}, []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        named[t.id] = node.value.value
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                srcs.append(node.value)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "replace" \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in named \
                    and all(isinstance(a, ast.Constant) for a in node.args):
                a, b = (arg.value for arg in node.args)
                srcs.append(named[node.func.value.id].replace(a, b))
        kept = []
        for s in srcs:
            s = textwrap.dedent(s)
            try:
                ast.parse(s)
            except SyntaxError:
                continue
            kept.append(s)
        out[fn.name] = kept
    return out


LINT_CASES = _race_sources("test_lint.py", "test_race_")
RACE_CASES = _race_sources("test_race.py", "test_")


def _as_tuples(findings):
    return [(f.path, f.line, f.col, f.rule, f.message, f.snippet)
            for f in findings]


@pytest.mark.parametrize("case", sorted(LINT_CASES) + sorted(
    f"race:{n}" for n in RACE_CASES if RACE_CASES[n]))
def test_race_findings_equal_the_references_on_its_planted_sources(case):
    srcs = (RACE_CASES[case[5:]] if case.startswith("race:")
            else LINT_CASES[case])
    assert srcs, case
    for src in srcs:
        for only in (["race-*"], None):
            want = ref_analysis.lint_source(src, "scratch.py", only=only)
            got = port_analysis.lint_source(src, "scratch.py", only=only)
            if only is None:
                # Both full suites run every family: compare the race
                # family's part of them.
                want = [f for f in want if f.rule.startswith("race-")]
                got = [f for f in got if f.rule.startswith("race-")]
            assert _as_tuples(got) == _as_tuples(want)


def test_the_planted_sources_exercise_every_race_rule():
    flagged = {f.rule for srcs in LINT_CASES.values() for src in srcs
               for f in port_analysis.lint_source(src, "scratch.py",
                                                  only=["race-*"])}
    assert flagged == {r.name for r in PORT_RULES}


def test_the_race_family_is_the_references_rule_set():
    assert [r.name for r in PORT_RULES] == [r.name for r in REF_RULES]
    assert [r.description for r in PORT_RULES] == [
        r.description.replace("moolib_tpu.testing", "moolib_tpu_torch.testing")
        for r in REF_RULES]
    assert [r.name for r in port_analysis.all_rules()
            if r.name.startswith("race-")] == [r.name for r in REF_RULES]
    with pytest.raises(port_analysis.LintError, match="unknown rule"):
        port_analysis.lint_source("x = 1\n", only=["race-nope-*"])


def test_static_lock_edges_of_the_reference_tree_are_identical():
    tree = [REPO_ROOT / "moolib_tpu"]
    got = static_lock_edges(tree, root=REPO_ROOT)
    assert got and got == ref_edges(tree, root=REPO_ROOT)


def test_race_findings_over_the_reference_tree_are_identical():
    tree = [REPO_ROOT / "moolib_tpu" / "rpc", REPO_ROOT / "moolib_tpu"
            / "parallel"]
    want = ref_analysis.lint_paths(tree, root=REPO_ROOT, only=["race-*"])
    got = port_analysis.lint_paths(tree, root=REPO_ROOT, only=["race-*"])
    assert _as_tuples(got) == _as_tuples(want)


def test_the_port_is_race_clean():
    """No race finding over the port that is neither repaired nor
    matched by a suppression the reference also carries."""
    found = port_analysis.lint_paths([REPO_ROOT / "moolib_tpu_torch"],
                                     root=REPO_ROOT, only=["race-*"])
    assert found == [], "\n".join(map(str, found))


@pytest.mark.parametrize("name", ["mut", "loc"])
def test_static_edges_of_the_references_planted_modules(tmp_path, name):
    src = {"test_static_edges_sound_under_mutual_recursion": "mut",
           "test_static_edges_resolve_function_local_locks": "loc"}
    (case,) = [c for c, n in src.items() if n == name]
    mods = [s for s in RACE_CASES[case] if "threading" in s]
    assert mods
    path = tmp_path / f"{name}.py"
    path.write_text(mods[0])
    got = static_lock_edges([path], root=tmp_path)
    assert got and got == ref_edges([path], root=tmp_path)


# -- locktrace: the reference's six unit cases under both tracers ---------------


def _load_module(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PLANTED = textwrap.dedent("""
    import threading
    a_lock = threading.Lock()
    b_lock = threading.Lock()

    def ab():
        with a_lock:
            with b_lock:
                pass

    def ba():
        with b_lock:
            with a_lock:
                pass
""")


def _traced(lt, root, body):
    """Run ``body(trace)`` under ``lt``'s tracer rooted at ``root``; only
    one tracer is ever active."""
    assert threading.Lock is _thread.allocate_lock, "a tracer is active"
    rlock = threading.RLock
    with lt.LockTrace(root=root) as trace:
        body(trace)
    assert threading.Lock is _thread.allocate_lock
    assert threading.RLock is rlock
    return trace


def _violation(fn):
    try:
        fn()
    except AssertionError as e:
        return type(e).__name__, str(e)
    return None


def _case_inversion(lt, tmp):
    (tmp / "planted.py").write_text(PLANTED)

    def body(trace):
        mod = _load_module(tmp / "planted.py")
        mod.ab()
        mod.ba()
    trace = _traced(lt, tmp, body)
    kind, msg = _violation(trace.assert_acyclic)
    assert msg.count("first observed at") == 2
    assert "in ab" in msg and "in ba" in msg
    return trace.edges(), kind


def _case_consistent(lt, tmp):
    (tmp / "planted.py").write_text(PLANTED)

    def body(trace):
        mod = _load_module(tmp / "planted.py")
        mod.ab()
        mod.ab()
    trace = _traced(lt, tmp, body)
    return trace.edges(), _violation(trace.assert_acyclic)


def _case_reentrant(lt, tmp):
    (tmp / "reent.py").write_text(textwrap.dedent("""
        import threading
        r_lock = threading.RLock()

        def twice():
            with r_lock:
                with r_lock:
                    pass
    """))
    trace = _traced(lt, tmp,
                    lambda t: _load_module(tmp / "reent.py").twice())
    return trace.edges(include_same_name=True), _violation(
        trace.assert_acyclic)


def _case_factory_bindings(lt, tmp):
    (tmp / "indirect.py").write_text(textwrap.dedent("""
        import threading
        mk = threading.Lock
        hidden = mk()                 # no factory call on THIS line
        named_lock = threading.Lock()

        def nest():
            with hidden:
                with named_lock:
                    pass
    """))

    def body(trace):
        _load_module(tmp / "indirect.py").nest()
        t = threading.Thread(target=lambda: None)
        t.start()
        t.join()
    trace = _traced(lt, tmp, body)
    return trace.edges(include_same_name=True), None


def _case_within(lt, tmp):
    (tmp / "planted.py").write_text(PLANTED)
    trace = _traced(lt, tmp, lambda t: _load_module(tmp / "planted.py").ab())
    known = {(("planted.py", "a_lock"), ("planted.py", "b_lock"))}
    assert _violation(lambda: trace.assert_within(known)) is None
    kind, msg = _violation(lambda: trace.assert_within(set()))
    assert "missing from the static" in msg
    assert "planted.py:a_lock -> planted.py:b_lock" in msg
    return trace.edges(), kind


def _case_per_thread(lt, tmp):
    (tmp / "two.py").write_text(textwrap.dedent("""
        import threading
        a_lock = threading.Lock()
        b_lock = threading.Lock()
    """))

    def body(trace):
        m = _load_module(tmp / "two.py")
        entered, release = threading.Event(), threading.Event()

        def holder():
            with m.a_lock:
                entered.set()
                release.wait(5)

        t = threading.Thread(target=holder)
        t.start()
        assert entered.wait(5)
        with m.b_lock:
            pass
        release.set()
        t.join(5)
    trace = _traced(lt, tmp, body)
    return trace.edges(include_same_name=True), None


CASES = {
    "planted_inversion_reported_with_both_stacks": _case_inversion,
    "consistent_order_is_acyclic": _case_consistent,
    "reentrant_rlock_records_no_edge": _case_reentrant,
    "only_factory_bindings_are_named": _case_factory_bindings,
    "assert_within_reports_unknown_edge": _case_within,
    "threaded_edges_are_per_thread": _case_per_thread,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_locktrace_case_under_both_tracers(tmp_path, case):
    results = []
    for i, lt in enumerate(TRACERS):
        tmp = tmp_path / str(i)
        tmp.mkdir()
        results.append(CASES[case](lt, tmp))
    (ref_edges_, ref_kind), (port_edges, port_kind) = results
    assert port_edges == ref_edges_
    assert port_kind == ref_kind
    if case == "planted_inversion_reported_with_both_stacks":
        assert port_kind == "LockOrderViolation" and len(port_edges) == 2
    if case in ("reentrant_rlock_records_no_edge",
                "only_factory_bindings_are_named",
                "threaded_edges_are_per_thread"):
        assert port_edges == set()


def test_torch_machinery_locks_stay_unnamed():
    """Locks torch's own code creates while a trace is active (its
    profiler, a queue's condition) have no factory binding inside the
    root: unnamed, no edge, as the reference's tracer treats stdlib
    machinery."""
    def body(trace):
        q = queue.Queue()
        assert q.mutex._name is None
        x = torch.randn(8, 8)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            (x @ x).sum()
        named = threading.Lock()  # this line binds: it gets a name
        assert named._name == ("tests/test_torch_locktrace.py", "named")
    trace = _traced(port_lt, REPO_ROOT, body)
    assert trace.edges(include_same_name=True) == set()


# -- the port under its own tracer ----------------------------------------------


def test_port_scenarios_locktrace_clean():
    """drop_storm(1) and replica_kill(3) under the port's tracer: a
    non-empty, acyclic edge set inside the port's static edges."""
    from moolib_tpu_torch.testing.scenarios import SCENARIOS

    def body(trace):
        SCENARIOS["drop_storm"](1)
        SCENARIOS["replica_kill"](3, device="cpu")
    trace = _traced(port_lt, REPO_ROOT, body)
    assert trace.edges(), "no lock nesting observed"
    trace.assert_acyclic()
    static = port_lt.static_package_edges()
    trace.assert_within(static)
    assert all(s[0].startswith("moolib_tpu_torch/")
               and d[0].startswith("moolib_tpu_torch/") for s, d in static)


def test_chaos_soak_locktrace_runs_clean_and_counts_edges(tmp_path, capsys):
    """``chaos_soak --smoke --locktrace`` on the CPU: the pass runs under
    the tracer and reports its edge count, acyclic and within the static
    graph (it refused the flag before locktrace was ported)."""
    from moolib_tpu_torch.flightrec import disable_auto_capture
    from moolib_tpu_torch.tools import chaos_soak as soak

    try:
        rc = soak.main(["--smoke", "--locktrace", "--scenario",
                        "leader_loss", "--device", "cpu", "--incident-dir",
                        str(tmp_path / "inc")])
    finally:
        disable_auto_capture()  # main() enabled auto-capture globally
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "acyclic, within the static graph" in out
    report = json.loads(out.strip().splitlines()[-1])
    assert report["ok"] and report["locktrace"]["edges"] > 0
    assert "violation" not in report["locktrace"]


def test_locktrace_cost_reports_both_states(capsys):
    """``tools/locktrace_cost``: a lock's creation and acquire untraced
    and traced, and the two timed-gate scenarios' seconds each way, the
    traced run with its observed edges."""
    from moolib_tpu_torch.tools import locktrace_cost

    assert locktrace_cost.main(["--locks", "200", "--acquires", "2000",
                                "--rounds", "1"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rep) == {"untraced", "traced", "scenarios"}
    for state in ("untraced", "traced"):
        assert set(rep[state]) == {"create_us", "acquire_us"}
        assert all(v > 0 for v in rep[state].values())
    (run,) = rep["scenarios"]
    assert run["traced"]["edges"] > 0 and "edges" not in run["untraced"]
