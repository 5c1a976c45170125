"""moolint CLI of the port: static analysis for async-RPC safety, capture
hygiene, mesh/collective consistency, RPC round and wire balance,
threading races, resource lifecycles, hot-path and numerics discipline;
the twin of the reference's ``tools/moolint.py``.

Usage::

    python -m moolib_tpu_torch.tools.moolint [paths...]   # vs the baseline
    python -m moolib_tpu_torch.tools.moolint --check moolib_tpu_torch/
    python -m moolib_tpu_torch.tools.moolint --baseline-update
    python -m moolib_tpu_torch.tools.moolint --baseline-stats
    python -m moolib_tpu_torch.tools.moolint --list-rules
    python -m moolib_tpu_torch.tools.moolint --explain prng-key-reuse
    python -m moolib_tpu_torch.tools.moolint --format=json moolib_tpu_torch/
    python -m moolib_tpu_torch.tools.moolint --format=gha moolib_tpu_torch/
    python -m moolib_tpu_torch.tools.moolint --diff HEAD~1

Exit codes: 0 clean against the baseline, 1 new findings, 2 usage/engine
error. A stale baseline (entries the tree no longer has) warns but stays
green — shrink it with --baseline-update. Reference rules without a
torch counterpart are listed by --list-rules as not ported, and
--explain prints why.
"""

import argparse
import fnmatch
import json
import subprocess
import sys
from pathlib import Path

from moolib_tpu_torch.analysis.engine import (
    DEFAULT_CACHE,
    LintError,
    all_rules,
    diff_against_baseline,
    lint_paths,
    list_lint_files,
    load_baseline,
    not_ported_rules,
    save_baseline,
)

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
PACKAGE = REPO_ROOT / "moolib_tpu_torch"
DEFAULT_BASELINE = PACKAGE / "analysis" / "baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="moolint", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint (default: moolib_tpu_torch/)")
    ap.add_argument("--check", action="store_true",
                    help="explicit alias for the default lint-vs-baseline "
                         "mode (for CI entrypoints)")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                    help=f"baseline file (default: {DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding; ignore the baseline")
    ap.add_argument("--baseline-update", action="store_true",
                    help="write the current findings as the new baseline")
    ap.add_argument("--baseline-stats", action="store_true",
                    help="print the grandfathered-finding count (per rule "
                         "and per file), then exit")
    ap.add_argument("--fail-nonempty", action="store_true",
                    help="with --baseline-stats: exit 1 when any "
                         "grandfathered finding remains (the port's "
                         "baselines must stay empty)")
    ap.add_argument("--list-rules", action="store_true",
                    help="list registered rules (and the reference's rules "
                         "not ported, with why) and exit")
    ap.add_argument("--explain", action="append", default=None,
                    metavar="RULE",
                    help="print a rule's doc, bad/good example pair and "
                         "suppression grammar, sourced from the rule "
                         "class itself (or why a reference rule is not "
                         "ported); repeatable / comma lists; fnmatch "
                         "globs like 'num-*' explain a family; unknown "
                         "names are an error")
    ap.add_argument("--diff", metavar="REF", default=None,
                    help="lint only files changed vs the git REF "
                         "(committed, staged, unstaged, and untracked "
                         "changes), restricted to the requested paths; "
                         "no changed lintable files exits 0 with a note")
    ap.add_argument("--only", action="append", default=None, metavar="RULE",
                    help="run only these rules (repeatable / comma lists; "
                         "fnmatch globs like 'race-*' select a family)")
    ap.add_argument("--rule-times", action="store_true",
                    help="report per-rule wall-time for the lint run "
                         "(plus result-cache hit/miss counts); with "
                         "--baseline-stats, profiles the suite over the "
                         "package tree (honors --only, always uncached)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the per-file result cache (stored "
                         f"beside the baselines: {DEFAULT_CACHE.name}; "
                         "content-hash keyed per file inside a "
                         "whole-project-hash section)")
    ap.add_argument("--format", choices=("text", "json", "gha"),
                    default=None, dest="fmt",
                    help="output format: text (default), json "
                         "(machine-readable), gha (GitHub workflow "
                         "::error annotations for new findings)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="alias for --format=json")
    args = ap.parse_args(argv)
    if args.fmt is None:
        args.fmt = "json" if args.as_json else "text"
    elif args.as_json and args.fmt != "json":
        print("moolint: error: --json conflicts with "
              f"--format={args.fmt}", file=sys.stderr)
        return 2
    args.as_json = args.fmt == "json"

    if args.explain:
        patterns = [r for chunk in args.explain
                    for r in chunk.split(",") if r]
        return explain_rules(patterns, as_json=args.as_json)

    if args.list_rules:
        return list_rules(as_json=args.as_json)

    only = None
    if args.only:
        only = [r for chunk in args.only for r in chunk.split(",") if r]

    if args.baseline_stats:
        if args.paths:
            # Stats come from the baseline FILE, not from linting paths.
            print("moolint: error: --baseline-stats takes no paths; pick "
                  "the ledger with --baseline", file=sys.stderr)
            return 2
        return baseline_stats(args, only)

    paths = [Path(p) for p in (args.paths or [PACKAGE])]
    if args.diff is not None:
        if args.baseline_update:
            # A diff-scoped lint sees a slice of the tree; writing that
            # slice out as the baseline would drop every other file's
            # entries.
            print("moolint: error: --diff conflicts with "
                  "--baseline-update (a partial lint must not rewrite "
                  "the whole ledger)", file=sys.stderr)
            return 2
        paths = _changed_lint_files(args.diff, paths)
        if paths is None:
            return 2
        if not paths:
            print(f"moolint: --diff {args.diff}: no changed lintable "
                  "files under the requested paths; nothing to lint")
            return 0

    timings = {} if args.rule_times else None
    cache_stats = None if args.no_cache else {}
    try:
        findings = lint_paths(
            paths, root=REPO_ROOT, only=only, timings=timings,
            cache_path=None if args.no_cache else DEFAULT_CACHE,
            cache_stats=cache_stats,
        )
    except LintError as e:
        print(f"moolint: error: {e}", file=sys.stderr)
        return 2

    if args.baseline_update:
        args.baseline.parent.mkdir(parents=True, exist_ok=True)
        save_baseline(args.baseline, findings)
        print(f"moolint: baseline updated: {len(findings)} finding(s) "
              f"-> {args.baseline}")
        return 0

    baseline = None
    if not args.no_baseline and args.baseline.exists():
        try:
            baseline = load_baseline(args.baseline)
        except LintError as e:
            print(f"moolint: error: {e}", file=sys.stderr)
            return 2
    elif not args.no_baseline:
        print(f"moolint: note: no baseline at {args.baseline}; every "
              "finding is new (run --baseline-update to grandfather)",
              file=sys.stderr)

    if baseline is not None:
        # Scope the comparison to the files actually linted: entries for
        # un-linted files are neither violated nor "fixed".
        linted = set(list_lint_files(paths, root=REPO_ROOT))
        baseline = {
            "version": baseline["version"],
            "findings": [e for e in baseline.get("findings", [])
                         if e["path"] in linted],
        }
    new, fixed = diff_against_baseline(findings, baseline)

    if args.as_json:
        out = {
            "findings": [f.to_dict() for f in findings],
            "new": [f.to_dict() for f in new],
            "fixed_baseline_entries": fixed,
        }
        if timings is not None:
            out["rule_seconds"] = {
                k: round(v, 4) for k, v in timings.items()
            }
            if cache_stats is not None:
                out["cache"] = cache_stats
        print(json.dumps(out, indent=1))
    else:
        for f in new:
            if args.fmt == "gha":
                # GitHub workflow-command annotation: surfaces on the PR
                # diff at the offending line. Newlines would terminate the
                # command mid-message, so escape per the GHA spec.
                msg = f"{f.rule}: {f.message}".replace("%", "%25") \
                    .replace("\r", "%0D").replace("\n", "%0A")
                print(f"::error file={f.path},line={f.line},"
                      f"col={f.col + 1},title=moolint::{msg}")
            else:
                print(str(f))
        grandfathered = len(findings) - len(new)
        print(
            f"moolint: {len(findings)} finding(s): {len(new)} new, "
            f"{grandfathered} baselined"
            + (f", {sum(e['count'] for e in fixed)} baseline entr(ies) "
               "fixed — shrink with --baseline-update" if fixed else "")
        )
        if timings is not None:
            _print_rule_times(timings)
            if cache_stats is not None:
                print(f"moolint: cache: {cache_stats.get('hits', 0)} "
                      f"hit(s), {cache_stats.get('misses', 0)} miss(es) "
                      f"({DEFAULT_CACHE.name}; --no-cache disables)")
    return 1 if new else 0


def _changed_lint_files(ref: str, requested):
    """Lintable files changed vs git ``ref`` — committed, staged, and
    unstaged changes (``git diff --name-only REF``) plus untracked files
    — intersected with what linting ``requested`` would visit. Returns
    None on a git failure (unknown ref, not a repo): the caller exits 2.
    Files deleted since REF show in the diff but not in the lintable
    set, so they drop out naturally."""
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", "-z", ref, "--"],
            cwd=REPO_ROOT, capture_output=True, text=True, check=True)
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard", "-z"],
            cwd=REPO_ROOT, capture_output=True, text=True, check=True)
    except (subprocess.CalledProcessError, OSError) as e:
        msg = (getattr(e, "stderr", "") or str(e)).strip()
        print(f"moolint: error: --diff {ref}: {msg}", file=sys.stderr)
        return None
    changed = {p for out in (diff.stdout, untracked.stdout)
               for p in out.split("\0") if p}
    try:
        scoped = list_lint_files(requested, root=REPO_ROOT)
    except LintError as e:
        print(f"moolint: error: {e}", file=sys.stderr)
        return None
    return [REPO_ROOT / rel for rel in scoped if rel in changed]


def list_rules(as_json=False) -> int:
    rules = all_rules()
    missing = not_ported_rules()
    if as_json:
        print(json.dumps(
            [{"name": r.name, "description": r.description}
             for r in rules]
            + [{"name": name, "not_ported": why}
               for name, why in sorted(missing.items())], indent=1,
        ))
        return 0
    for rule in rules:
        print(f"{rule.name}")
        print(f"    {rule.description}\n")
    for name, why in sorted(missing.items()):
        print(f"{name}  [not ported]")
        print(f"    {why}\n")
    return 0


def explain_rules(patterns, as_json=False) -> int:
    """``--explain``: everything printed comes off the Rule class (name,
    family, description, the class docstring as the long-form doc, the
    example pair, the suppression grammar) so the CLI can never drift
    from the implementation. Patterns use the same fnmatch semantics as
    --only (a glob matches the rule name or its family-qualified
    ``<family>-<name>`` form); a reference rule the port does not have
    prints the reason; a pattern matching nothing is an exit-code-2
    error, not silence."""
    import inspect

    from moolib_tpu_torch.analysis.engine import _select_rules

    missing = not_ported_rules()
    unported = {name: why for name, why in missing.items()
                if any(fnmatch.fnmatchcase(name, p) for p in patterns)}
    rule_patterns = [p for p in patterns
                     if not any(fnmatch.fnmatchcase(n, p) for n in unported)
                     or any(fnmatch.fnmatchcase(r.name, p)
                            for r in all_rules())]
    try:
        selected = _select_rules(None, rule_patterns) if rule_patterns \
            else []
    except LintError as e:
        print(f"moolint: error: {e}", file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps([{
            "name": r.name,
            "family": r.family,
            "description": r.description,
            "doc": inspect.cleandoc(r.__doc__ or ""),
            "example_bad": r.example_bad,
            "example_good": r.example_good,
            "suppression": r.suppression_grammar(),
        } for r in selected] + [{
            "name": name, "not_ported": why,
        } for name, why in sorted(unported.items())], indent=1))
        return 0
    blocks = 0
    for r in selected:
        if blocks:
            print()
        blocks += 1
        title = f"{r.name}" + (f"  [family: {r.family}]" if r.family else "")
        print(title)
        print("=" * len(title))
        print(r.description)
        doc = inspect.cleandoc(r.__doc__ or "")
        if doc:
            print()
            print(doc)
        if r.example_bad:
            print("\nflagged:")
            for line in r.example_bad.splitlines():
                print(f"    {line}")
        if r.example_good:
            print("\nclean:")
            for line in r.example_good.splitlines():
                print(f"    {line}")
        print(f"\nsuppression: {r.suppression_grammar()}")
    for name, why in sorted(unported.items()):
        if blocks:
            print()
        blocks += 1
        title = f"{name}  [not ported]"
        print(title)
        print("=" * len(title))
        print(why)
    return 0


def _print_rule_times(timings: dict):
    total = sum(timings.values())
    print(f"moolint: per-rule wall-time ({total:.2f}s total):")
    for rule, secs in sorted(timings.items(), key=lambda kv: -kv[1]):
        print(f"  {secs * 1000:8.1f}ms  {rule}")


def baseline_stats(args, only=None) -> int:
    """Burn-down visibility: how much grandfathered debt remains; with
    --rule-times, also profiles the suite over the package tree so the
    burn-down line and the per-rule cost land in one CI block."""
    if not args.baseline.exists():
        print(f"moolint: baseline {args.baseline}: absent (0 grandfathered "
              "findings)")
        return 0
    try:
        baseline = load_baseline(args.baseline)
    except LintError as e:
        print(f"moolint: error: {e}", file=sys.stderr)
        return 2
    entries = baseline.get("findings", [])
    total = sum(int(e.get("count", 1)) for e in entries)
    rc = 1 if (args.fail_nonempty and total) else 0
    per_rule: dict = {}
    per_file: dict = {}
    for e in entries:
        n = int(e.get("count", 1))
        per_rule[e["rule"]] = per_rule.get(e["rule"], 0) + n
        per_file[e["path"]] = per_file.get(e["path"], 0) + n
    timings = None
    if args.rule_times:
        timings = {}
        try:
            lint_paths([PACKAGE], root=REPO_ROOT, only=only, timings=timings)
        except LintError as e:
            print(f"moolint: error: {e}", file=sys.stderr)
            return 2
    if args.as_json:
        out = {
            "baseline": str(args.baseline),
            "total": total,
            "per_rule": per_rule,
            "per_file": per_file,
        }
        if timings is not None:
            out["rule_seconds"] = {
                k: round(v, 4) for k, v in timings.items()
            }
        print(json.dumps(out, indent=1))
    else:
        print(f"moolint: baseline {args.baseline.name}: {total} "
              f"grandfathered finding(s) across {len(per_file)} file(s)")
        for rule, n in sorted(per_rule.items(), key=lambda kv: -kv[1]):
            print(f"  {n:4d}  {rule}")
        for path, n in sorted(per_file.items(), key=lambda kv: -kv[1]):
            print(f"  {n:4d}  {path}")
        if timings is not None:
            _print_rule_times(timings)
    if rc:
        print(f"moolint: error: {args.baseline} grandfathers {total} "
              "finding(s); the port's baselines ship empty and must stay "
              "empty — fix or suppress (with a reason) instead of "
              "re-baselining", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
