"""The lint engine of the port: AST walk, findings, suppressions; the
counterpart of the part of :mod:`moolib_tpu.analysis.engine` that the
race family (:mod:`.rules_race`) and :func:`lint_source` /
:func:`lint_paths` need.

- A :class:`Rule` inspects one parsed module (:class:`ModuleContext`) and
  yields :class:`Finding`\\ s. Rules are pure functions of the AST +
  source; they never import the code under analysis.
- Per-line suppression: ``# moolint: disable=<rule>[,<rule>...]`` on the
  flagged line (or ``disable=all``). File-wide:
  ``# moolint: disable-file=<rule>[,...]`` anywhere in the file. Families
  with a reasoned marker grammar (racelint's ``# racelint: unguarded --
  <reason>``) read :attr:`ModuleContext.comments` themselves.
- Interprocedural layer: :func:`lint_paths` parses every file first and
  hands each :class:`ModuleContext` a shared :class:`ProjectIndex`, so a
  rule can look across modules (the race family's project-wide lock
  graph).

Findings are identified by ``(path, rule, stripped source line)``, the
reference's baseline identity. The reference's baselines, result cache,
endpoint registry and CLI are not here: nothing in the port calls them
yet (ROADMAP.md queue A, item 12).
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "LintError",
    "ModuleContext",
    "ProjectIndex",
    "Rule",
    "all_rules",
    "iter_py_files",
    "iter_scoped_body",
    "lint_paths",
    "lint_source",
    "terminal_name",
]

_SUPPRESS_RE = re.compile(r"#\s*moolint:\s*disable=([\w\-,]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*moolint:\s*disable-file=([\w\-,]+)")


class LintError(RuntimeError):
    """Unrecoverable engine error (unreadable file, unknown rule)."""


# Nodes that open a new execution context: walks stop at their boundary.
_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                ast.Lambda)


def iter_scoped_body(stmts: Iterable[ast.AST]) -> Iterator[ast.AST]:
    """Every node under the given statements without crossing into nested
    function/class bodies or lambdas (they execute in a different
    context). Nested defs are yielded — callers can see them — but never
    entered. THE shared scoped-walk for all rule modules; do not grow
    private copies (they diverge)."""
    stack = list(stmts)
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, _SCOPE_NODES):
            continue
        stack.extend(ast.iter_child_nodes(n))


def terminal_name(node: Optional[ast.expr]) -> Optional[str]:
    """'foo' for Name foo, 'bar' for a.b.bar; None otherwise. The shared
    callee-name extractor for all rule modules."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location."""

    path: str  # posix path, repo-relative when under the lint root
    line: int  # 1-based
    col: int   # 0-based
    rule: str
    message: str
    snippet: str = ""  # stripped source line — the baseline identity

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


class Rule:
    """Base class: subclasses set ``name``/``description`` and implement
    :meth:`check`. Registration happens via the rule modules' ``RULES``
    lists (see :func:`all_rules`)."""

    name: str = ""
    description: str = ""

    def check(self, ctx: "ModuleContext") -> Iterable[Finding]:
        raise NotImplementedError

    # Convenience for subclasses.
    def finding(self, ctx: "ModuleContext", node: ast.AST,
                message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = ctx.line(line).strip()
        return Finding(path=ctx.relpath, line=line, col=col,
                       rule=self.name, message=message, snippet=snippet)


class ModuleContext:
    """One parsed module plus the derived facts rules share."""

    def __init__(self, source: str, relpath: str):
        self.source = source
        self.relpath = relpath
        self.lines = source.splitlines()
        try:
            self.tree = ast.parse(source, filename=relpath)
        except SyntaxError as e:
            raise LintError(f"{relpath}: syntax error: {e}") from None
        # Every context belongs to a project; standalone contexts get a
        # single-module one so rules never special-case its absence.
        self.project: "ProjectIndex" = ProjectIndex()
        self.project.add(self)
        self._suppressed_lines: Dict[int, set] = {}
        self._suppressed_file: set = set()
        self._scan_suppressions()

    # -- suppressions --------------------------------------------------------

    def _scan_suppressions(self):
        """Collect suppression comments via tokenize (comments are invisible
        to ast). Malformed/partial source falls back to a line regex scan."""
        try:
            tokens = list(tokenize.generate_tokens(
                iter(self.source.splitlines(keepends=True)).__next__
            ))
        except (tokenize.TokenError, IndentationError):
            tokens = None
        comments: List[Tuple[int, str]] = []
        if tokens is not None:
            comments = [
                (tok.start[0], tok.string)
                for tok in tokens if tok.type == tokenize.COMMENT
            ]
        else:
            for i, text in enumerate(self.lines, start=1):
                if "#" in text:
                    comments.append((i, text[text.index("#"):]))
        #: (lineno, comment text) for every REAL comment — string
        #: literals containing '#' are not comments. Shared with rule
        #: modules that define their own marker grammars (rules_race).
        self.comments: List[Tuple[int, str]] = comments
        for lineno, text in comments:
            m = _SUPPRESS_FILE_RE.search(text)
            if m:
                self._suppressed_file.update(m.group(1).split(","))
                continue
            m = _SUPPRESS_RE.search(text)
            if m:
                self._suppressed_lines.setdefault(lineno, set()).update(
                    m.group(1).split(",")
                )

    def suppressed(self, rule: str, line: int) -> bool:
        if {"all", rule} & self._suppressed_file:
            return True
        rules = self._suppressed_lines.get(line)
        return bool(rules) and bool({"all", rule} & rules)

    # -- helpers -------------------------------------------------------------

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


class ProjectIndex:
    """All modules of one lint invocation — the shared interprocedural
    layer. Rules that look across modules (the race family's lock graph)
    walk :attr:`contexts` and cache their project-wide results on the
    index."""

    def __init__(self, contexts: Sequence[ModuleContext] = ()):
        self.contexts: List[ModuleContext] = []
        for ctx in contexts:
            self.add(ctx)

    def add(self, ctx: ModuleContext):
        self.contexts.append(ctx)
        ctx.project = self


# -- running -----------------------------------------------------------------


def all_rules() -> List[Rule]:
    """The registered rule set: the families ported so far (guarded-field
    / lock-order race analysis)."""
    from . import rules_race

    return [cls() for cls in rules_race.RULES]


def _select_rules(rules: Optional[Sequence[Rule]],
                  only: Optional[Sequence[str]]) -> List[Rule]:
    """``only`` entries are rule names or fnmatch globs (``race-*``
    selects the whole family). A pattern matching nothing is an error,
    not a silently-empty run."""
    selected = list(rules) if rules is not None else all_rules()
    if only:
        wanted: set = set()
        unknown: List[str] = []
        for pat in only:
            hits = {r.name for r in selected
                    if fnmatch.fnmatchcase(r.name, pat)}
            if not hits:
                unknown.append(pat)
            wanted |= hits
        if unknown:
            raise LintError(f"unknown rule(s): {sorted(unknown)}")
        selected = [r for r in selected if r.name in wanted]
    return selected


def lint_source(source: str, relpath: str = "<string>",
                rules: Optional[Sequence[Rule]] = None,
                only: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint one source string; the unit-test surface."""
    ctx = ModuleContext(source, relpath)
    out: List[Finding] = []
    for rule in _select_rules(rules, only):
        for f in rule.check(ctx):
            if not ctx.suppressed(f.rule, f.line):
                out.append(f)
    return sorted(out)


def iter_py_files(paths: Sequence[Path]) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for sub in sorted(p.rglob("*.py")):
                # Filter on the path BELOW the scanned root only: a repo
                # checked out under a dot-directory ancestor must still
                # lint (filtering sub.parts would skip everything,
                # silently passing vacuously).
                rel_parts = sub.relative_to(p).parts
                if any(part.startswith(".") for part in rel_parts):
                    continue
                if "__pycache__" in rel_parts:
                    continue
                yield sub
        elif p.suffix == ".py":
            yield p
        elif not p.exists():
            raise LintError(f"no such path: {p}")


def lint_paths(paths: Sequence[Path], root: Optional[Path] = None,
               rules: Optional[Sequence[Rule]] = None,
               only: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint files/trees. ``root`` anchors the relative paths findings carry
    (default: the current working directory); files outside ``root`` fall
    back to absolute paths so they can never collide with in-root ones."""
    root = Path(root) if root is not None else Path.cwd()
    selected = _select_rules(rules, only)
    # Phase 1: parse everything, so phase 2 rules can resolve names across
    # modules through the shared ProjectIndex.
    contexts: List[ModuleContext] = []
    for path in iter_py_files(paths):
        try:
            source = path.read_text(encoding="utf-8")
        except (OSError, UnicodeDecodeError) as e:
            raise LintError(f"cannot read {path}: {e}") from None
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.resolve().as_posix()
        try:
            contexts.append(ModuleContext(source, rel))
        except LintError:
            # A file that does not parse is someone else's failure (the
            # import suite); the linter skips it rather than masking every
            # other finding behind one broken scratch file.
            continue
    project = ProjectIndex(contexts)

    out: List[Finding] = []
    for ctx in contexts:
        assert ctx.project is project
        for rule in selected:
            for f in rule.check(ctx):
                if not ctx.suppressed(f.rule, f.line):
                    out.append(f)
    return sorted(out)
