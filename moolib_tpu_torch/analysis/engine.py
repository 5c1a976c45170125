"""moolint engine of the port: AST walk, findings, suppressions,
baseline, result cache; the counterpart of
:mod:`moolib_tpu.analysis.engine`, whole and unchanged in what it finds.

Design (mirrors how large projects keep a lint suite adoptable):

- A :class:`Rule` inspects one parsed module (:class:`ModuleContext`) and
  yields :class:`Finding`\\ s. Rules are pure functions of the AST + source;
  they never import the code under analysis.
- Per-line suppression: ``# moolint: disable=<rule>[,<rule>...]`` on the
  flagged line (or ``disable=all``). File-wide:
  ``# moolint: disable-file=<rule>[,...]`` anywhere in the file.
- Baseline: pre-existing findings are grandfathered in a checked-in JSON
  file so the suite can land on a non-clean tree and still fail NEW
  violations. Findings are identified by ``(path, rule, stripped source
  line)`` — not line numbers — so unrelated edits that shift code do not
  invalidate the baseline; duplicates are tracked by count.
- Interprocedural layer: :func:`lint_paths` parses every file first and
  hands each :class:`ModuleContext` a shared :class:`ProjectIndex`, so a
  rule can follow a name through ONE from-import hop into another linted
  module (e.g. resolve ``make_mesh`` axis names from
  ``parallel/mesh.py`` while checking ``learner.py``). Resolution is
  strictly best-effort: anything the index cannot see resolves to None
  and the rule must stay silent rather than guess.
- Wire-surface layer: the index also builds a project-wide **endpoint
  registry** from every ``define``/``define_queue``/``define_deferred``
  call (:meth:`ProjectIndex.endpoints`). Endpoint names are abstracted to
  wildcard patterns (:func:`name_pattern`) so f-string registrations like
  ``f"{name}::step"`` resolve against literal and f-string call sites by
  pattern overlap (:func:`patterns_overlap`); handler signatures resolve
  through module functions, local defs, ``self.<method>`` references,
  lambdas, and the decorator form, feeding the ``rules_wire`` family.
- Rules of the reference with no torch counterpart are not registered:
  :func:`not_ported_rules` names each with the reason (``moolint
  --list-rules`` and ``--explain`` print them).
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import hashlib
import json
import re
import time
import tokenize
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "DEFAULT_CACHE",
    "EndpointDef",
    "EndpointSig",
    "Finding",
    "LintError",
    "ModuleContext",
    "ProjectIndex",
    "Rule",
    "WILDCARD",
    "all_rules",
    "diff_against_baseline",
    "findings_to_baseline",
    "iter_py_files",
    "iter_scoped",
    "iter_scoped_body",
    "lint_paths",
    "lint_source",
    "list_lint_files",
    "load_baseline",
    "name_pattern",
    "not_ported_rules",
    "pattern_display",
    "patterns_overlap",
    "receiver_name",
    "returned_calls",
    "save_baseline",
    "terminal_name",
]

BASELINE_VERSION = 1
CACHE_VERSION = 1
#: Per-file result cache, stored beside the baselines (gitignored). See
#: :func:`lint_paths` — sections are keyed by a whole-project hash, so
#: the interprocedural layer stays sound: editing ANY linted file (or
#: any analysis module) starts a fresh section.
DEFAULT_CACHE = Path(__file__).resolve().parent / "lint_cache.json"
_CACHE_KEEP_PROJECTS = 4

_SUPPRESS_RE = re.compile(r"#\s*moolint:\s*disable=([\w\-,]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*moolint:\s*disable-file=([\w\-,]+)")


class LintError(RuntimeError):
    """Unrecoverable engine error (unreadable file, bad baseline)."""


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


def iter_scoped(root: ast.AST) -> Iterator[ast.AST]:
    """Like :func:`iter_scoped_body`, for one node: the root is always
    expanded, even when it is itself a def."""
    yield root
    yield from iter_scoped_body(ast.iter_child_nodes(root))


def terminal_name(node: Optional[ast.expr]) -> Optional[str]:
    """'foo' for Name foo, 'bar' for a.b.bar; None otherwise. The shared
    callee-name extractor for all rule modules."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


# -- endpoint-name abstraction ------------------------------------------------

#: Wildcard sentinel inside an abstracted endpoint-name pattern. NUL can
#: never appear in a real endpoint string, so patterns stay plain strings.
WILDCARD = "\0"


def name_pattern(node: Optional[ast.expr]) -> Optional[str]:
    """Abstract an endpoint-name expression to a wildcard pattern.

    A string literal is itself; an f-string keeps its literal fragments
    with each ``{...}`` hole collapsed to :data:`WILDCARD` (so
    ``f"{name}::step"`` becomes ``\\0::step``). Anything else (a variable,
    a ``+`` concat, ``str.format``) returns None — unresolvable names must
    silence wire rules, never make them guess."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts: List[str] = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            elif isinstance(v, ast.FormattedValue):
                parts.append(WILDCARD)
            else:
                return None
        # Collapse adjacent wildcards: "** " and "*" match the same set.
        out = "".join(parts)
        while WILDCARD * 2 in out:
            out = out.replace(WILDCARD * 2, WILDCARD)
        return out
    return None


def pattern_display(pattern: str) -> str:
    """Human-readable form of a wildcard pattern (``{*}`` per hole)."""
    return pattern.replace(WILDCARD, "{*}")


def patterns_overlap(a: str, b: str) -> bool:
    """Can any concrete endpoint name match BOTH wildcard patterns?

    Classic two-glob intersection nonemptiness, where each wildcard
    matches any (possibly empty) string. Endpoint names are short, so the
    memoized (i, j) recursion is plenty."""
    seen: Dict[Tuple[int, int], bool] = {}

    def go(i: int, j: int) -> bool:
        key = (i, j)
        if key in seen:
            return seen[key]
        seen[key] = False  # cycle guard (two facing wildcards)
        if i == len(a) and j == len(b):
            out = True
        elif i < len(a) and a[i] == WILDCARD:
            out = go(i + 1, j) or (j < len(b) and go(i, j + 1))
        elif j < len(b) and b[j] == WILDCARD:
            out = go(i, j + 1) or (i < len(a) and go(i + 1, j))
        elif i < len(a) and j < len(b) and a[i] == b[j]:
            out = go(i + 1, j + 1)
        else:
            out = False
        seen[key] = out
        return out

    return go(0, 0)


#: The registration surface of the RPC layer (``rpc/rpc.py``).
ENDPOINT_DEFINERS = ("define", "define_queue", "define_deferred")


@dataclasses.dataclass
class EndpointDef:
    """One ``define``/``define_queue``/``define_deferred`` registration."""

    pattern: str              # wildcard name pattern
    kind: str                 # one of ENDPOINT_DEFINERS
    ctx: "ModuleContext"      # module the registration lives in
    node: ast.Call            # the define call
    handler: Optional[ast.AST] = None  # FunctionDef/AsyncFunctionDef/Lambda
    handler_is_method: bool = False    # drop the leading ``self`` param

    def display(self) -> str:
        return pattern_display(self.pattern)

    def signature(self) -> Optional["EndpointSig"]:
        """The handler's PAYLOAD signature (``self`` and the deferred
        handle dropped), or None when unknown / a queue endpoint (queues
        accept anything — arity is the consumer's business)."""
        if self.handler is None or self.kind == "define_queue":
            return None
        a = self.handler.args
        params = [p.arg for p in list(a.posonlyargs) + list(a.args)]
        drop = (1 if self.handler_is_method else 0) + (
            1 if self.kind == "define_deferred" else 0
        )
        if len(params) < drop:
            return None  # malformed handler; don't guess
        params = params[drop:]
        kw_defaulted = {
            p.arg for p, d in zip(a.kwonlyargs, a.kw_defaults)
            if d is not None
        }
        return EndpointSig(
            params=params,
            n_defaults=len(a.defaults),
            has_vararg=a.vararg is not None,
            has_kwarg=a.kwarg is not None,
            kwonly=[p.arg for p in a.kwonlyargs],
            kwonly_required=[
                p.arg for p in a.kwonlyargs if p.arg not in kw_defaulted
            ],
        )


@dataclasses.dataclass
class EndpointSig:
    """Payload-facing handler signature (see :meth:`EndpointDef.signature`)."""

    params: List[str]
    n_defaults: int
    has_vararg: bool
    has_kwarg: bool
    kwonly: List[str]
    kwonly_required: List[str]


def receiver_name(node: Optional[ast.expr]) -> Optional[str]:
    """Dotted receiver of an attribute access (``self.rpc`` for
    ``self.rpc.define(...)``'s func.value); None when any link is not a
    plain Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def returned_calls(fn: ast.AST) -> List[ast.Call]:
    """Call expressions ``fn`` can return directly (scoped walk — nested
    defs excluded). The one-hop leg of Future-origin dataflow: a function
    whose returns are all RPC calls produces RPC futures."""
    if isinstance(fn, ast.Lambda):
        return [fn.body] if isinstance(fn.body, ast.Call) else []
    out: List[ast.Call] = []
    for node in iter_scoped_body(getattr(fn, "body", [])):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Call):
            out.append(node.value)
    return out


def _local_defs(body: Iterable[ast.stmt]) -> Dict[str, ast.AST]:
    return {
        n.name: n for n in body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _module_endpoints(ctx: "ModuleContext") -> List["EndpointDef"]:
    """Every endpoint registration in one module, with handlers resolved
    through local defs, ``self.<method>`` references, lambdas, the
    decorator form, and (via the project) one from-import hop."""
    out: List[EndpointDef] = []
    # Decorator-form registrations: ``@rpc.define("name")`` above a def
    # binds THAT def as the handler (the define call sees no fn arg).
    decorated: Dict[int, Tuple[ast.AST, bool]] = {}

    def handle_call(call: ast.Call, cls: Optional[ast.ClassDef],
                    scopes: List[Dict[str, ast.AST]]):
        kind = terminal_name(call.func)
        if kind not in ENDPOINT_DEFINERS \
                or not isinstance(call.func, ast.Attribute):
            return  # a bare define() is not a registration on an Rpc
        if not call.args:
            return
        pattern = name_pattern(call.args[0])
        if pattern is None:
            return  # unresolvable name: the registration stays invisible
        handler: Optional[ast.AST] = None
        is_method = False
        if id(call) in decorated:
            handler, is_method = decorated[id(call)]
        elif kind != "define_queue" and len(call.args) >= 2:
            h = call.args[1]
            if isinstance(h, ast.Lambda):
                handler = h
            elif (isinstance(h, ast.Attribute)
                    and isinstance(h.value, ast.Name)
                    and h.value.id == "self" and cls is not None):
                for n in cls.body:
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and n.name == h.attr:
                        handler, is_method = n, True
                        break
            elif isinstance(h, ast.Name):
                for sc in reversed(scopes):
                    if h.id in sc:
                        handler = sc[h.id]
                        break
                else:
                    resolved = ctx.project.resolve_function(ctx, h.id)
                    if resolved is not None:
                        handler = resolved[1]
        out.append(EndpointDef(pattern=pattern, kind=kind, ctx=ctx,
                               node=call, handler=handler,
                               handler_is_method=is_method))

    def visit(node: ast.AST, cls: Optional[ast.ClassDef],
              scopes: List[Dict[str, ast.AST]]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                for sub in ast.walk(dec):
                    if isinstance(sub, ast.Call) and len(sub.args) == 1 \
                            and terminal_name(sub.func) in ENDPOINT_DEFINERS:
                        decorated[id(sub)] = (node, cls is not None)
                visit_expr(dec, cls, scopes)
            inner = scopes + [_local_defs(node.body)]
            for child in node.body:
                visit(child, cls, inner)
            return
        if isinstance(node, ast.ClassDef):
            for child in node.body:
                visit(child, node, scopes)
            return
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.Call):
            handle_call(node, cls, scopes)
        for child in ast.iter_child_nodes(node):
            visit(child, cls, scopes)

    def visit_expr(node, cls, scopes):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                handle_call(sub, cls, scopes)

    top = [_local_defs(ctx.tree.body)]
    for stmt in ctx.tree.body:
        visit(stmt, None, top)
    return out


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location."""

    path: str  # posix path, repo-relative when under the lint root
    line: int  # 1-based
    col: int   # 0-based
    rule: str
    message: str
    snippet: str = ""  # stripped source line — the baseline identity

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: line numbers intentionally excluded."""
        return (self.path, self.rule, self.snippet)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


class Rule:
    """Base class: subclasses set ``name``/``description`` and implement
    :meth:`check`. Registration happens via the rule modules' ``RULES``
    lists (see :func:`all_rules`)."""

    name: str = ""
    description: str = ""
    #: Family tag for ``--only`` globbing: a pattern also matches
    #: ``"<family>-<name>"``, so ``hot-*`` selects the whole hotlint
    #: family even though its rule names keep their descriptive spellings
    #: (host-transfer-in-steploop etc.). Empty = name-only matching.
    family: str = ""
    #: Optional seeded/clean example pair for ``moolint --explain`` —
    #: sourced here (the rule class) so the CLI and docs can never drift
    #: from the implementation. Empty = no example published yet.
    example_bad: str = ""
    example_good: str = ""

    def suppression_grammar(self) -> str:
        """How to silence this rule in place. Families with a reasoned
        marker grammar (race/hot/life/num) override the default
        ``# moolint: disable=<rule>`` engine-level form."""
        if self.family in ("race", "hot", "life", "num"):
            marker = {"race": "racelint: unguarded",
                      "hot": "hotlint: sync",
                      "life": "lifelint: intentional",
                      "num": f"numlint: {self.name}"}[self.family]
            return (f"# {marker} -- <reason>   "
                    f"(a bare marker suppresses nothing and is itself "
                    f"flagged)")
        return f"# moolint: disable={self.name}"

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


def _module_name_of(relpath: str) -> Tuple[Optional[str], bool]:
    """(dotted module name, is_package) for a repo-relative posix path;
    (None, False) when the path does not look like an importable module
    (absolute paths, ``<string>`` scratch sources, odd names)."""
    if not relpath.endswith(".py") or relpath.startswith("/"):
        return None, False
    parts = relpath[:-3].split("/")
    is_package = parts[-1] == "__init__"
    if is_package:
        parts = parts[:-1]
    if not parts or not all(p.isidentifier() for p in parts):
        return None, False
    return ".".join(parts), is_package


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
        self.module_name, self.is_package = _module_name_of(relpath)
        # Every context belongs to a project; standalone contexts get a
        # single-module one so rules never special-case its absence.
        self.project: "ProjectIndex" = ProjectIndex()
        self.project.add(self)
        self._symbols: Optional[dict] = None
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

    def imports_any(self, *modules: str) -> bool:
        """True if the module imports any of ``modules`` (top-level name
        match, e.g. 'concurrent' matches 'concurrent.futures')."""
        tops = set(modules)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[0] in tops:
                        return True
            elif isinstance(node, ast.ImportFrom):
                if node.module and node.module.split(".")[0] in tops:
                    return True
        return False

    def has_async_def(self) -> bool:
        return any(
            isinstance(n, ast.AsyncFunctionDef) for n in ast.walk(self.tree)
        )

    # -- module symbol table (interprocedural layer) -------------------------

    def _symbol_table(self) -> dict:
        """Lazily-built top-level view: function defs, simple assignments,
        and import bindings (local name -> dotted source module + original
        name). Only MODULE-level statements — locals are a rule's job."""
        if self._symbols is not None:
            return self._symbols
        functions: Dict[str, ast.AST] = {}
        assigns: Dict[str, ast.expr] = {}
        imports: Dict[str, Tuple[str, str]] = {}
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                functions[node.name] = node
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        assigns[t.id] = node.value
            elif isinstance(node, ast.AnnAssign):
                if isinstance(node.target, ast.Name) and node.value is not None:
                    assigns[node.target.id] = node.value
            elif isinstance(node, ast.ImportFrom):
                mod = self._absolutize_import(node)
                if mod is not None:
                    for alias in node.names:
                        if alias.name != "*":
                            imports[alias.asname or alias.name] = (
                                mod, alias.name
                            )
        self._symbols = {
            "functions": functions, "assigns": assigns, "imports": imports
        }
        return self._symbols

    def _absolutize_import(self, node: ast.ImportFrom) -> Optional[str]:
        """Dotted absolute module for a from-import, resolving relative
        levels against this module's package; None when unresolvable."""
        if node.level == 0:
            return node.module
        if self.module_name is None:
            return None
        parts = self.module_name.split(".")
        if not self.is_package:
            parts = parts[:-1]
        drop = node.level - 1
        if drop > len(parts):
            return None
        if drop:
            parts = parts[:-drop]
        if node.module:
            parts = parts + node.module.split(".")
        return ".".join(parts) if parts else None

    @property
    def top_functions(self) -> Dict[str, ast.AST]:
        return self._symbol_table()["functions"]

    @property
    def top_assigns(self) -> Dict[str, ast.expr]:
        return self._symbol_table()["assigns"]

    @property
    def import_bindings(self) -> Dict[str, Tuple[str, str]]:
        return self._symbol_table()["imports"]


class ProjectIndex:
    """All modules of one lint invocation, keyed by dotted name — the
    shared interprocedural layer. Lookups are ONE import hop deep: a name
    visible in a module either is a local top-level def or came in through
    a single from-import from another linted module."""

    def __init__(self, contexts: Sequence[ModuleContext] = ()):
        self.by_name: Dict[str, ModuleContext] = {}
        self.contexts: List[ModuleContext] = []
        self._endpoints: Optional[List[EndpointDef]] = None
        for ctx in contexts:
            self.add(ctx)

    def add(self, ctx: ModuleContext):
        if ctx.module_name is not None:
            self.by_name[ctx.module_name] = ctx
        self.contexts.append(ctx)
        ctx.project = self
        self._endpoints = None  # registry is rebuilt after membership changes

    def endpoints(self) -> List["EndpointDef"]:
        """The project-wide endpoint registry: every ``define`` /
        ``define_queue`` / ``define_deferred`` registration across all
        linted modules (including ones whose path doesn't map to a dotted
        module name — scratch files still register). Built lazily, once
        per lint run."""
        if self._endpoints is None:
            eps: List[EndpointDef] = []
            for ctx in self.contexts:
                eps.extend(_module_endpoints(ctx))
            self._endpoints = eps
        return self._endpoints

    def module(self, dotted: Optional[str]) -> Optional[ModuleContext]:
        return self.by_name.get(dotted) if dotted else None

    def resolve_function(
        self, ctx: ModuleContext, name: str
    ) -> Optional[Tuple[ModuleContext, ast.AST]]:
        """(defining ctx, FunctionDef) for ``name`` as visible from
        ``ctx``: a module-level def, or one from-import hop away."""
        node = ctx.top_functions.get(name)
        if node is not None:
            return ctx, node
        bound = ctx.import_bindings.get(name)
        if bound is None:
            return None
        target = self.module(bound[0])
        if target is None:
            return None
        node = target.top_functions.get(bound[1])
        if node is None:
            return None
        return target, node


# -- running -----------------------------------------------------------------


#: The rule families of the port, in the reference's registration order.
_FAMILIES = ("rules_async", "rules_jax", "rules_sharding", "rules_protocol",
             "rules_wire", "rules_bench", "rules_race", "rules_lifecycle",
             "rules_hot", "rules_num")


def _family_modules() -> list:
    import importlib

    return [importlib.import_module(f"{__package__}.{name}")
            for name in _FAMILIES]


def all_rules() -> List[Rule]:
    """The full registered rule set (async-safety + torch capture hygiene
    + mesh/collective consistency + RPC round/counter balance + RPC
    wire-surface consistency + benchmark timing hygiene + guarded-field
    / lock-order race analysis + resource-lifecycle / shutdown-path
    analysis + hot-path device/host discipline + numerics/determinism
    discipline). Rules of the reference without a torch counterpart are
    not in it: see :func:`not_ported_rules`."""
    return [cls() for mod in _family_modules() for cls in mod.RULES]


def not_ported_rules() -> Dict[str, str]:
    """Rule name -> why the port has no counterpart, for every rule of
    the reference that :func:`all_rules` leaves out (each family's
    ``NOT_PORTED``)."""
    out: Dict[str, str] = {}
    for mod in _family_modules():
        out.update(getattr(mod, "NOT_PORTED", {}))
    return out


def _select_rules(rules: Optional[Sequence[Rule]],
                  only: Optional[Sequence[str]]) -> List[Rule]:
    """``only`` entries are rule names or fnmatch globs (``race-*``
    selects the whole family); a pattern also matches a rule's
    family-qualified name (:attr:`Rule.family` + ``-`` + name), so
    ``hot-*`` selects every hotlint rule. A pattern matching nothing is
    an error, not a silently-empty run."""
    selected = list(rules) if rules is not None else all_rules()
    if only:
        wanted: set = set()
        unknown: List[str] = []
        for pat in only:
            hits = {
                r.name for r in selected
                if fnmatch.fnmatchcase(r.name, pat)
                or (r.family
                    and fnmatch.fnmatchcase(f"{r.family}-{r.name}", pat))
            }
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


def list_lint_files(paths: Sequence[Path],
                    root: Optional[Path] = None) -> List[str]:
    """Relative (posix) paths of the files a :func:`lint_paths` call with
    the same arguments would visit — used to scope baseline comparisons to
    what was actually linted."""
    root = Path(root) if root is not None else Path.cwd()
    out = []
    for path in iter_py_files(paths):
        try:
            out.append(path.resolve().relative_to(root.resolve()).as_posix())
        except ValueError:
            out.append(path.resolve().as_posix())
    return out


def _ruleset_hash(selected: Sequence[Rule]) -> str:
    """Hash of the selected rule names PLUS the analysis package's own
    source: editing any rule module (or this engine) must invalidate
    every cached result, not just renamed rules."""
    h = hashlib.sha256()
    for name in sorted(r.name for r in selected):
        h.update(name.encode())
        h.update(b"\0")
    pkg = Path(__file__).resolve().parent
    for mod in sorted(pkg.glob("*.py")):
        h.update(mod.name.encode())
        try:
            h.update(hashlib.sha256(mod.read_bytes()).digest())
        except OSError:
            h.update(b"?")
    return h.hexdigest()


def _load_cache(path: Path) -> dict:
    try:
        data = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return {"version": CACHE_VERSION, "stamp": 0, "projects": {}}
    if not isinstance(data, dict) or data.get("version") != CACHE_VERSION \
            or not isinstance(data.get("projects"), dict):
        return {"version": CACHE_VERSION, "stamp": 0, "projects": {}}
    return data


def _save_cache(path: Path, data: dict) -> None:
    # Keep only the newest sections: a repo being edited cycles through
    # project hashes fast, and each section holds every file's findings.
    projects = data["projects"]
    if len(projects) > _CACHE_KEEP_PROJECTS:
        keep = sorted(projects, key=lambda k: projects[k].get("stamp", 0),
                      reverse=True)[:_CACHE_KEEP_PROJECTS]
        data["projects"] = {k: projects[k] for k in keep}
    try:
        Path(path).write_text(json.dumps(data) + "\n", encoding="utf-8")
    except OSError:
        pass  # a read-only checkout lints fine, just uncached


def lint_paths(paths: Sequence[Path], root: Optional[Path] = None,
               rules: Optional[Sequence[Rule]] = None,
               only: Optional[Sequence[str]] = None,
               timings: Optional[Dict[str, float]] = None,
               cache_path: Optional[Path] = None,
               cache_stats: Optional[Dict[str, int]] = None) -> List[Finding]:
    """Lint files/trees. ``root`` anchors the relative paths findings carry
    (default: the current working directory); files outside ``root`` fall
    back to absolute paths so they can never collide with baselined ones.
    When ``timings`` is a dict it receives per-rule wall-time (rule name
    -> cumulative seconds across all files) — the profiling surface
    behind ``moolint --rule-times``.

    ``cache_path`` enables the per-file result cache: results are keyed
    by each file's content hash *inside a section keyed by the hash of
    the whole linted file set plus the analysis package itself*, so the
    interprocedural layer stays sound — ANY edit anywhere opens a fresh
    section and every file re-lints; the common no-change run is all
    hits and ~instant. ``cache_stats`` (a dict) receives ``hits`` /
    ``misses`` counters for ``--rule-times`` reporting."""
    root = Path(root) if root is not None else Path.cwd()
    selected = _select_rules(rules, only)
    # Phase 1: parse everything, so phase 2 rules can resolve names across
    # modules through the shared ProjectIndex.
    contexts: List[ModuleContext] = []
    file_hashes: Dict[str, str] = {}
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
        file_hashes[rel] = hashlib.sha256(source.encode()).hexdigest()
    project = ProjectIndex(contexts)

    cache = section = None
    if cache_path is not None:
        h = hashlib.sha256(_ruleset_hash(selected).encode())
        for rel in sorted(file_hashes):
            h.update(rel.encode())
            h.update(file_hashes[rel].encode())
        project_key = h.hexdigest()
        cache = _load_cache(cache_path)
        cache["stamp"] = int(cache.get("stamp", 0)) + 1
        section = cache["projects"].setdefault(
            project_key, {"files": {}}
        )
        section["stamp"] = cache["stamp"]
    if cache_stats is not None:
        cache_stats.setdefault("hits", 0)
        cache_stats.setdefault("misses", 0)

    out: List[Finding] = []
    dirty = False
    for ctx in contexts:
        assert ctx.project is project
        if section is not None:
            entry = section["files"].get(ctx.relpath)
            if entry is not None \
                    and entry.get("hash") == file_hashes[ctx.relpath]:
                # Sound by construction: this section's key covers every
                # linted file AND the analysis source, so a hash-matched
                # entry was produced by exactly this run's inputs.
                out.extend(Finding(**d) for d in entry["findings"])
                if cache_stats is not None:
                    cache_stats["hits"] += 1
                continue
        if cache_stats is not None and section is not None:
            cache_stats["misses"] += 1
        file_findings: List[Finding] = []
        for rule in selected:
            t0 = time.perf_counter() if timings is not None else 0.0
            for f in rule.check(ctx):
                if not ctx.suppressed(f.rule, f.line):
                    file_findings.append(f)
            if timings is not None:
                timings[rule.name] = timings.get(rule.name, 0.0) \
                    + (time.perf_counter() - t0)
        out.extend(file_findings)
        if section is not None:
            section["files"][ctx.relpath] = {
                "hash": file_hashes[ctx.relpath],
                "findings": [f.to_dict() for f in file_findings],
            }
            dirty = True
    if cache is not None and (dirty or len(cache["projects"]) >
                              _CACHE_KEEP_PROJECTS):
        _save_cache(cache_path, cache)
    return sorted(out)


# -- baseline ----------------------------------------------------------------


def findings_to_baseline(findings: Iterable[Finding]) -> dict:
    counts = Counter(f.key() for f in findings)
    return {
        "version": BASELINE_VERSION,
        "findings": [
            {"path": path, "rule": rule, "snippet": snippet, "count": n}
            for (path, rule, snippet), n in sorted(counts.items())
        ],
    }


def save_baseline(path: Path, findings: Iterable[Finding]):
    data = findings_to_baseline(findings)
    Path(path).write_text(json.dumps(data, indent=1) + "\n", encoding="utf-8")


def load_baseline(path: Path) -> dict:
    try:
        data = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError) as e:
        raise LintError(f"cannot load baseline {path}: {e}") from None
    if not isinstance(data, dict) or data.get("version") != BASELINE_VERSION:
        raise LintError(f"baseline {path}: unsupported format")
    return data


def diff_against_baseline(
    findings: Sequence[Finding], baseline: Optional[dict]
) -> Tuple[List[Finding], List[dict]]:
    """-> (new findings, fixed baseline entries).

    A finding is NEW when its (path, rule, snippet) count exceeds the
    baselined count; a baseline entry is FIXED when the tree now has fewer
    occurrences than baselined (the baseline should be shrunk with
    ``--baseline-update``)."""
    allowed: Counter = Counter()
    if baseline is not None:
        for e in baseline.get("findings", []):
            allowed[(e["path"], e["rule"], e["snippet"])] += int(
                e.get("count", 1)
            )
    seen: Counter = Counter()
    new: List[Finding] = []
    for f in sorted(findings):
        seen[f.key()] += 1
        if seen[f.key()] > allowed.get(f.key(), 0):
            new.append(f)
    fixed = [
        {"path": k[0], "rule": k[1], "snippet": k[2],
         "count": n - seen.get(k, 0)}
        for k, n in sorted(allowed.items()) if seen.get(k, 0) < n
    ]
    return new, fixed
