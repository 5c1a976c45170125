"""numlint of the port: numerics & determinism discipline; the torch
counterpart of :mod:`moolib_tpu.analysis.rules_num`.

Seeded parity — two runs from the same seed giving the same bits — is
what every perf change of the port is judged against. These rules police
the ways code silently loses it: generator discipline (two streams
seeded alike draw alike; reseeding with the same seed inside a loop
replays one stream every iteration), unseeded randomness (torch's and
numpy's process-global generators have no seed contract), precision
discipline (a bf16/fp16 reduction or matmul rounds its result to the
operand dtype; mixing bf16 with f32 tensors or float literals leaves the
result dtype to promotion) and reduction-order determinism (iterating a
set into a tensor or a reduce payload makes the summation order
hash-seed dependent).

The dynamic mirror is :mod:`moolib_tpu_torch.testing.paritywatch` (and
the learner's ``cudnn.deterministic`` pin): these rules catch what is
visible lexically; ParityWatch replays a seeded callable and asserts the
bits actually match.

Suppression grammar (mirrors racelint/hotlint/lifelint): a finding is
silenced by a *reasoned* marker naming the rule on the flagged line::

    # numlint: prng-key-reuse -- every replica must draw the same stream

A bare marker (no reason) suppresses nothing and is itself flagged by
``num-bare-suppression``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .engine import (Finding, ModuleContext, Rule, iter_scoped,
                     iter_scoped_body, terminal_name)
from .rules_hot import _is_module_class
from .rules_jax import _numpy_aliases, _torch_aliases, traced_functions

__all__ = ["RULES"]

_FN_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOOP_NODES = (ast.For, ast.AsyncFor, ast.While)

#: One regex for marker + reason: rule names are hyphenated, so the
#: reason MUST be set off by an explicit ``--`` (or em/en dash) — a
#: looser separator class would backtrack into the rule name itself.
_NUM_MARKER_RE = re.compile(
    r"#\s*numlint:\s*([a-z][a-z0-9-]*[a-z0-9]|[a-z])"
    r"\s*(?:(?:--|—|–)\s*(\S.*))?")

#: np.random module-level functions that draw from (or reseed) the
#: process-global MT19937 state — the no-seed-contract surface.
_NP_GLOBAL_RANDOM = {
    "beta", "binomial", "bytes", "chisquare", "choice", "dirichlet",
    "exponential", "gamma", "geometric", "gumbel", "laplace", "logistic",
    "lognormal", "multinomial", "multivariate_normal", "normal",
    "permutation", "poisson", "rand", "randint", "randn", "random",
    "random_sample", "ranf", "sample", "seed", "shuffle",
    "standard_normal", "uniform", "vonmises", "weibull",
}

#: torch samplers that draw from the process-global generator unless
#: given ``generator=``: module functions, and the in-place tensor
#: methods (their trailing underscore is torch's alone).
_TORCH_SAMPLERS = {
    "bernoulli", "multinomial", "normal", "poisson", "rand", "rand_like",
    "randint", "randint_like", "randn", "randn_like", "randperm",
}
_TORCH_INPLACE_SAMPLERS = {
    "bernoulli_", "cauchy_", "exponential_", "geometric_", "log_normal_",
    "normal_", "random_", "uniform_",
}

_LOWPREC_DTYPES = {"float16", "bfloat16", "half"}
_FP64_DTYPES = {"float64", "double"}
_F32_DTYPES = {"float32", "float"}
#: Reductions and products whose result takes the operand dtype unless
#: widened (``dtype=``) or fed upcast operands.
_ACCUM_METHODS = {"sum", "mean", "cumsum", "prod", "matmul", "mm", "bmm"}
_ACCUM_FUNCS = _ACCUM_METHODS | {"einsum"}
#: Tensor methods that keep their receiver's dtype.
_DTYPE_KEEPING = {"view", "reshape", "contiguous", "clone", "detach",
                  "transpose", "permute", "flatten", "squeeze", "unsqueeze",
                  "t", "expand", "to", "type"}


# -- suppression grammar ------------------------------------------------------


def _num_suppressions(ctx: ModuleContext) -> Dict[int, List[Tuple[str, bool]]]:
    """line -> [(rule, has_reason), ...] for every ``# numlint:`` marker.
    Only real comments count (``ctx.comments`` is tokenize-derived), so
    markers inside fixture strings neither suppress nor trip the bare
    rule. Memoized on the context: every rule in the family consults it."""
    cached = getattr(ctx, "_num_suppressions", None)
    if cached is not None:
        return cached
    out: Dict[int, List[Tuple[str, bool]]] = {}
    for i, text in ctx.comments:
        if "numlint" not in text:
            continue
        m = _NUM_MARKER_RE.search(text)
        if m is None:
            continue
        out.setdefault(i, []).append(
            (m.group(1), bool(m.group(2) and m.group(2).strip()))
        )
    ctx._num_suppressions = out
    return out


def _suppressed(ctx: ModuleContext, node: ast.AST, rule: str) -> bool:
    for marked, reasoned in _num_suppressions(ctx).get(
            getattr(node, "lineno", -1), ()):
        if reasoned and marked in (rule, "all"):
            return True
    return False


def _scopes(ctx: ModuleContext) -> List[List[ast.stmt]]:
    """The module body and every function body (each walked without
    entering nested defs)."""
    out: List[List[ast.stmt]] = [ctx.tree.body]
    for node in ast.walk(ctx.tree):
        if isinstance(node, _FN_NODES):
            out.append(node.body)
    return out


def _is_time_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) \
        and isinstance(node.func, ast.Attribute) \
        and node.func.attr in ("time", "time_ns", "monotonic",
                               "monotonic_ns", "perf_counter",
                               "perf_counter_ns") \
        and terminal_name(node.func.value) == "time"


def _has_time_arg(call: ast.Call) -> bool:
    return any(_is_time_call(node)
               for a in list(call.args) + [kw.value for kw in call.keywords]
               for node in ast.walk(a))


# -- generator seeding ----------------------------------------------------------


def _seed_call(node: ast.AST) -> Optional[ast.Call]:
    """``<generator>.manual_seed(s)``, ``torch.manual_seed(s)``,
    ``torch.cuda.manual_seed(s)`` (one positional seed)."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "manual_seed" and len(node.args) == 1:
        return node
    return None


def _seed_names(expr: ast.expr) -> Optional[Set[str]]:
    """The names a seed expression reads, when it is trackable: a
    literal (no names), a plain name, or ``self.attr``; None otherwise
    (computed seeds — ``seed + rank`` — are distinct by design)."""
    if isinstance(expr, ast.Constant):
        return set()
    if isinstance(expr, ast.Name):
        return {expr.id}
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self":
        return {f"self.{expr.attr}"}
    return None


def _stored_names(stmts: List[ast.stmt]) -> Set[str]:
    out: Set[str] = set()
    for node in iter_scoped_body(stmts):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Store) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            out.add(f"self.{node.attr}")
    return out


class PrngKeyReuse(Rule):
    """Two generator streams seeded alike draw the same numbers: a
    ``torch.Generator`` (or the global one) seeded twice in one scope with
    the same literal or the same unchanged name starts the second stream
    where the first began, and ``manual_seed(s)`` inside a loop with a
    loop-invariant ``s`` replays one stream every iteration. Sibling
    branches of an ``if`` are exclusive and never pair. Computed seeds
    (``seed + rank``) are distinct by design and stay clean. torch
    generators are stateful, so drawing twice from one generator advances
    it: only reseeding can reuse a stream."""

    name = "prng-key-reuse"
    family = "num"
    description = (
        "a torch generator is seeded again with the same literal or name "
        "(or reseeded inside a loop with a loop-invariant seed): the "
        "streams replay each other — derive a distinct seed per stream"
    )
    example_bad = (
        "g_env = torch.Generator().manual_seed(seed)\n"
        "g_net = torch.Generator().manual_seed(seed)   # same stream twice"
    )
    example_good = (
        "g_env = torch.Generator().manual_seed(seed)\n"
        "g_net = torch.Generator().manual_seed(seed + 1)"
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for body in _scopes(ctx):
            seen: Dict[Tuple, Tuple[int, List[Tuple[int, str]]]] = {}
            self._walk(ctx, body, seen, [], out, loops=[])
        return out

    def _walk(self, ctx, stmts, seen, branch, out, loops):
        for stmt in stmts:
            if isinstance(stmt, _FN_NODES + (ast.ClassDef,)):
                continue  # separate scope, checked on its own
            if isinstance(stmt, ast.If):
                self._scan(ctx, stmt.test, seen, branch, out, loops)
                self._walk(ctx, stmt.body, seen,
                           branch + [(id(stmt), "body")], out, loops)
                self._walk(ctx, stmt.orelse, seen,
                           branch + [(id(stmt), "else")], out, loops)
                continue
            if isinstance(stmt, _LOOP_NODES):
                header = [stmt.iter] if isinstance(
                    stmt, (ast.For, ast.AsyncFor)) else [stmt.test]
                for h in header:
                    self._scan(ctx, h, seen, branch, out, loops)
                self._walk(ctx, stmt.body, seen, branch, out,
                           loops + [stmt])
                self._walk(ctx, stmt.orelse, seen, branch, out, loops)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith, ast.Try)):
                for item in getattr(stmt, "items", []):
                    self._scan(ctx, item.context_expr, seen, branch, out,
                               loops)
                for part in ("body", "orelse", "finalbody"):
                    self._walk(ctx, getattr(stmt, part, []), seen, branch,
                               out, loops)
                for h in getattr(stmt, "handlers", []):
                    self._walk(ctx, h.body, seen, branch, out, loops)
                continue
            self._scan(ctx, stmt, seen, branch, out, loops)
            # A rebinding of a seed name starts a fresh value for it.
            stored = _stored_names([stmt])
            for key in [k for k in seen if set(k[1]) & stored]:
                del seen[key]

    def _scan(self, ctx, node, seen, branch, out, loops):
        for sub in ast.walk(node):
            call = _seed_call(sub)
            if call is None:
                continue
            names = _seed_names(call.args[0])
            if names is None:
                continue
            if loops and not names & _stored_names(
                    list(loops[-1].body) + list(getattr(
                        loops[-1], "orelse", []))) \
                    and not (isinstance(loops[-1], (ast.For, ast.AsyncFor))
                             and names & set(_target_ids(loops[-1].target))):
                if not _suppressed(ctx, call, self.name):
                    out.append(self.finding(
                        ctx, call,
                        f"manual_seed({ast.unparse(call.args[0])}) inside "
                        f"a loop with a loop-invariant seed — every "
                        f"iteration replays the same stream; derive the "
                        f"seed from the iteration",
                    ))
                continue
            key = (ast.dump(call.args[0]), tuple(sorted(names)))
            first = seen.get(key)
            if first is not None and not _exclusive(first[1], branch):
                if not _suppressed(ctx, call, self.name):
                    out.append(self.finding(
                        ctx, call,
                        f"generator seeded again with "
                        f"{ast.unparse(call.args[0])} (first at line "
                        f"{first[0]}) — the two streams draw the same "
                        f"numbers; derive a distinct seed per stream",
                    ))
                continue
            if first is None:
                seen[key] = (call.lineno, list(branch))


def _target_ids(target: ast.expr) -> List[str]:
    return [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]


def _exclusive(a: List[Tuple[int, str]], b: List[Tuple[int, str]]) -> bool:
    """Do two branch paths take different arms of one ``if``?"""
    arms = dict(a)
    return any(k in arms and arms[k] != arm for k, arm in b)


class UnseededRandomness(Rule):
    """Training/protocol code must not draw from a process-global
    generator (torch's, or numpy's np.random state: no seed contract —
    results change run to run and any import can reseed it) nor derive
    seeds from the clock. Draws given an explicit ``generator=``, seeded
    ``np.random.default_rng(seed)`` / ``Generator`` objects and the
    ``testing/`` chaos seams (which carry their own seed-replay
    discipline) stay clean; ``tests/``, the tools and bench scripts are
    out of scope — the rule polices the library's training+protocol
    paths."""

    name = "unseeded-randomness"
    family = "num"
    description = (
        "torch sampler without generator=, np.random module-state draw, "
        "or time-derived seed in a library path — draw from a seeded "
        "torch.Generator / np.random.default_rng"
    )
    example_bad = (
        "noise = torch.randn(batch.shape)              # global generator\n"
        "torch.manual_seed(int(time.time()))           # clock seed"
    )
    example_good = (
        "gen = torch.Generator().manual_seed(cfg.seed)\n"
        "noise = torch.randn(batch.shape, generator=gen)"
    )

    #: Path prefixes the rule polices; everything else (tests, tools,
    #: bench scripts, the testing/ chaos seams) is out of scope.
    _EXEMPT_PREFIXES = ("moolib_tpu_torch/testing/", "moolib_tpu_torch/tools/",
                        "tests/", "tools/", "bench")

    def _in_scope(self, ctx: ModuleContext) -> bool:
        p = ctx.relpath
        if any(p.startswith(e) for e in self._EXEMPT_PREFIXES):
            return False
        return p.startswith("moolib_tpu_torch/") or p == "<string>"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not self._in_scope(ctx):
            return []
        out: List[Finding] = []
        np_names = _numpy_aliases(ctx)
        torch_names = _torch_aliases(ctx)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            msg = None
            fn = node.func
            if self._is_global_np_draw(node, np_names):
                msg = (f"np.random.{fn.attr} draws from the process-global "
                       f"RNG state — no seed contract; use a seeded "
                       f"np.random.default_rng(seed)")
            elif self._is_global_torch_draw(node, torch_names):
                what = (f"torch.{fn.attr}" if fn.attr in _TORCH_SAMPLERS
                        else f".{fn.attr}()")
                msg = (f"{what} without generator= draws from torch's "
                       f"process-global generator — no seed contract; pass "
                       f"a seeded torch.Generator")
            else:
                sink = self._seed_sink(node, np_names)
                if sink and _has_time_arg(node):
                    msg = (f"{sink} seeded from the clock — the run cannot "
                           f"be replayed; thread a config seed through")
            if msg and not _suppressed(ctx, node, self.name):
                out.append(self.finding(ctx, node, msg))
        return out

    @staticmethod
    def _is_global_np_draw(call: ast.Call, np_names: Set[str]) -> bool:
        fn = call.func
        return (isinstance(fn, ast.Attribute)
                and fn.attr in _NP_GLOBAL_RANDOM
                and isinstance(fn.value, ast.Attribute)
                and fn.value.attr == "random"
                and isinstance(fn.value.value, ast.Name)
                and fn.value.value.id in np_names)

    @staticmethod
    def _is_global_torch_draw(call: ast.Call, torch_names: Set[str]) -> bool:
        fn = call.func
        if not isinstance(fn, ast.Attribute) \
                or any(kw.arg == "generator" for kw in call.keywords):
            return False
        if fn.attr in _TORCH_INPLACE_SAMPLERS:
            return True
        return fn.attr in _TORCH_SAMPLERS \
            and isinstance(fn.value, ast.Name) and fn.value.id in torch_names

    @staticmethod
    def _seed_sink(call: ast.Call, np_names: Set[str]) -> Optional[str]:
        """A callable whose argument is a seed: manual_seed (torch's or a
        generator's), default_rng/Generator/SeedSequence/seed, stdlib
        random.seed."""
        f = call.func
        if not isinstance(f, ast.Attribute):
            return None
        if f.attr == "manual_seed":
            return "manual_seed"
        if f.attr in ("default_rng", "SeedSequence", "Generator", "seed"):
            return f"np.random.{f.attr}" if terminal_name(f.value) in (
                np_names | {"random"}) else None
        return None


# -- precision ------------------------------------------------------------------


def _dtype_kind(expr: ast.expr) -> Optional[str]:
    """'low' for torch.bfloat16/float16/half (or the string), 'f32',
    'f64', or None."""
    name = expr.value if isinstance(expr, ast.Constant) \
        and isinstance(expr.value, str) else terminal_name(expr)
    if name in _LOWPREC_DTYPES:
        return "low"
    if name in _F32_DTYPES:
        return "f32"
    if name in _FP64_DTYPES:
        return "f64"
    return None


def _expr_kind(expr: ast.expr, kinds: Dict[str, str]) -> Optional[str]:
    """The floating dtype class ('low' / 'f32') ``expr`` provably has:
    ``dtype=`` constructions, ``.to(dtype)``/``.type(dtype)``,
    ``.bfloat16()``/``.half()``/``.float()``, dtype-keeping methods of a
    known tensor, names, and arithmetic over them; None when unknown."""
    if isinstance(expr, ast.Name):
        return kinds.get(expr.id)
    if isinstance(expr, ast.Call):
        for kw in expr.keywords:
            if kw.arg == "dtype":
                return _dtype_kind(kw.value)
        fn = expr.func
        if not isinstance(fn, ast.Attribute):
            return None
        if fn.attr in ("bfloat16", "half"):
            return "low"
        if fn.attr == "float":
            return "f32"
        if fn.attr == "double":
            return "f64"
        if fn.attr in ("to", "type"):
            for a in expr.args:
                k = _dtype_kind(a)
                if k is not None:
                    return k
        if fn.attr in _DTYPE_KEEPING:
            return _expr_kind(fn.value, kinds)
        return None
    if isinstance(expr, ast.BinOp):
        a, b = _expr_kind(expr.left, kinds), _expr_kind(expr.right, kinds)
        if a == b or b is None:
            return a
        return b if a is None else None
    return None


def _dtype_kinds(body: List[ast.stmt]) -> Dict[str, str]:
    """name -> dtype class for names provably bound to bf16/fp16 ('low')
    or f32 tensors in this scope. Assignments replay in source order
    (iter_scoped_body is unordered); an unknown rebinding forgets the
    name."""
    kinds: Dict[str, str] = {}
    assigns = [n for n in iter_scoped_body(body)
               if isinstance(n, (ast.Assign, ast.AnnAssign))]
    for node in sorted(assigns, key=lambda n: n.lineno):
        if node.value is None:
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        kind = _expr_kind(node.value, kinds)
        for n in names:
            if kind in ("low", "f32"):
                kinds[n] = kind
            else:
                kinds.pop(n, None)
    return kinds


def _low(expr: ast.expr, kinds: Dict[str, str]) -> bool:
    return _expr_kind(expr, kinds) == "low"


class LowprecAccumulate(Rule):
    """bf16/fp16 storage is fine; a bf16/fp16 *reduction or product* is
    not: ``sum``/``mean``/``cumsum``/``matmul``/``einsum``/``bmm`` over a
    low-precision tensor return the operand dtype, so the result is
    rounded to 8 (or 11) mantissa bits batch-size-dependently, which
    both hurts training and makes parity checks tolerance-dependent.
    Widen with ``dtype=torch.float32`` (reductions) or upcast the
    operands (``.float()``). Fires only on positive dtype evidence in the
    same scope (explicit ``dtype=``/``.to``/``.bfloat16()``)."""

    name = "lowprec-accumulate"
    family = "num"
    description = (
        "sum/mean/cumsum/matmul/einsum/bmm over a bf16/fp16 tensor "
        "without dtype=torch.float32 or an upcast"
    )
    example_bad = (
        "acts = h.to(torch.bfloat16)\n"
        "loss = acts.mean()               # result rounded to bf16\n"
        "y = torch.matmul(acts, w16)      # bf16 result"
    )
    example_good = (
        "acts = h.to(torch.bfloat16)\n"
        "loss = acts.mean(dtype=torch.float32)\n"
        "y = torch.matmul(acts.float(), w16.float())"
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        torch_names = _torch_aliases(ctx) | {"torch"}
        for body in _scopes(ctx):
            kinds = _dtype_kinds(body)
            if "low" not in kinds.values():
                continue
            for node in iter_scoped_body(body):
                found = self._accumulation(node, kinds, torch_names)
                if found and not _suppressed(ctx, node, self.name):
                    out.append(self.finding(ctx, node, found))
        return out

    @staticmethod
    def _accumulation(node: ast.AST, kinds: Dict[str, str],
                      torch_names: Set[str]) -> Optional[str]:
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            if _low(node.left, kinds) or _low(node.right, kinds):
                return ("`@` on a bf16/fp16 operand returns the operand "
                        "dtype — upcast the operands (.float()) first")
            return None
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            return None
        fn = node.func
        name = fn.attr
        if any(kw.arg == "dtype" for kw in node.keywords):
            return None
        if isinstance(fn.value, ast.Name) and fn.value.id in torch_names:
            # torch.sum(x) / torch.einsum(eq, a, b) module form.
            if name in _ACCUM_FUNCS and any(_low(a, kinds)
                                            for a in node.args):
                return (f"torch.{name} over a bf16/fp16 tensor returns the "
                        f"operand dtype — pass dtype=torch.float32 or "
                        f"upcast the operands")
            return None
        # method form: t.sum() / t.matmul(w)
        if name in _ACCUM_METHODS and _low(fn.value, kinds):
            return (f".{name}() on a bf16/fp16 tensor returns the operand "
                    f"dtype — pass dtype=torch.float32 or upcast first")
        return None


def _step_bodies(ctx: ModuleContext) -> List[ast.AST]:
    """The defs a step runs: functions torch.compile traces, ``forward``
    of ``nn.Module`` subclasses, and the inner defs the port's step
    factories (``make_*_step``) return."""
    out: List[ast.AST] = list(traced_functions(ctx))
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef) \
                and _is_module_class(ctx, node.name):
            out.extend(m for m in node.body if isinstance(m, _FN_NODES)
                       and m.name == "forward")
        elif isinstance(node, _FN_NODES) and node.name.startswith("make_") \
                and node.name.endswith("_step"):
            inner = {n.name: n for n in node.body
                     if isinstance(n, _FN_NODES)}
            for sub in iter_scoped_body(node.body):
                if isinstance(sub, ast.Return) \
                        and isinstance(sub.value, ast.Name) \
                        and sub.value.id in inner:
                    out.append(inner[sub.value.id])
    seen: Set[int] = set()
    return [fn for fn in out if not (id(fn) in seen or seen.add(id(fn)))]


class ImplicitDtypePromotion(Rule):
    """Inside a step, combining a bf16/fp16 tensor with an f32 tensor
    leaves the result dtype to torch's promotion (the step silently runs
    in f32 from there on), a Python float literal is silently rounded to
    the low-precision dtype, and an fp64 dtype doubles the op's cost on
    the card. All three are drift a parity gate cannot attribute. Fires
    in functions torch.compile traces, ``nn.Module.forward`` and the
    defs the step factories return."""

    name = "implicit-dtype-promotion"
    family = "num"
    description = (
        "inside a step: a bf16/fp16 tensor combined with an f32 tensor "
        "or a Python float literal, or an fp64 dtype"
    )
    example_bad = (
        "def forward(self, x16):              # x16 = x.to(torch.bfloat16)\n"
        "    x16 = x.to(torch.bfloat16)\n"
        "    return x16 * 0.1 + self.bias.float()"
    )
    example_good = (
        "def forward(self, x):\n"
        "    x16 = x.to(torch.bfloat16)\n"
        "    return x16 * torch.tensor(0.1, dtype=torch.bfloat16)"
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for fn in _step_bodies(ctx):
            in_dtype_kwarg = {
                id(kw.value)
                for node in iter_scoped(fn) if isinstance(node, ast.Call)
                for kw in node.keywords if kw.arg == "dtype"
            }
            for node in iter_scoped(fn):
                if isinstance(node, ast.Call):
                    for kw in node.keywords:
                        if kw.arg == "dtype" \
                                and _dtype_kind(kw.value) == "f64" \
                                and not _suppressed(ctx, node, self.name):
                            out.append(self.finding(
                                ctx, node,
                                "fp64 dtype inside a step — it doubles the "
                                "op's cost on the card and drifts from "
                                "the f32/bf16 path; pin f32 (or bf16) "
                                "explicitly",
                            ))
                elif isinstance(node, ast.Attribute) \
                        and node.attr in _FP64_DTYPES \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id != "self" \
                        and id(node) not in in_dtype_kwarg \
                        and not _suppressed(ctx, node, self.name):
                    out.append(self.finding(
                        ctx, node,
                        f"{node.value.id}.{node.attr} referenced inside a "
                        f"step — an fp64 dtype on the step's path",
                    ))
            kinds = _dtype_kinds(fn.body)
            if "low" not in kinds.values():
                continue
            for node in iter_scoped_body(fn.body):
                if not isinstance(node, ast.BinOp) \
                        or isinstance(node.op, ast.MatMult) \
                        or _suppressed(ctx, node, self.name):
                    continue
                msg = self._mix(node, kinds)
                if msg:
                    out.append(self.finding(ctx, node, msg))
        return out

    @staticmethod
    def _mix(node: ast.BinOp, kinds: Dict[str, str]) -> Optional[str]:
        def is_float_lit(e: ast.expr) -> bool:
            if isinstance(e, ast.Constant):
                return isinstance(e.value, float)
            if isinstance(e, ast.UnaryOp):
                return is_float_lit(e.operand)
            return False

        left = _expr_kind(node.left, kinds)
        right = _expr_kind(node.right, kinds)
        if {left, right} == {"low", "f32"}:
            return ("bf16/fp16 tensor combined with an f32 tensor — "
                    "promotion makes the result f32; cast one side "
                    "explicitly")
        if (is_float_lit(node.left) and right == "low") \
                or (is_float_lit(node.right) and left == "low"):
            return ("Python float literal mixed into bf16/fp16 arithmetic "
                    "— it is rounded to the tensor's dtype; cast the scalar "
                    "explicitly")
        return None


class NondetIterationToTensor(Rule):
    """Iterating a set — or a dict built by iterating one — into a tensor
    (``torch.tensor``/``torch.stack``/``torch.cat``), a reduction, or a
    Group reduce payload makes element order hash-seed dependent, so fp
    summation order (and the bits of the result) differs across
    processes. Bit-replay and cross-peer parity both die here. Iterate
    ``sorted(...)`` instead. Plain dicts stay clean: insertion order is
    deterministic."""

    name = "nondet-iteration-to-tensor"
    family = "num"
    description = (
        "set(-seeded) iteration flows into tensor/stack/cat/reduction or "
        "an all_reduce payload — order is hash-seed dependent; sort first"
    )
    example_bad = (
        "names = {p.name for p in peers}\n"
        "flat = torch.stack([grads[n] for n in names])  # hash-order stack"
    )
    example_good = (
        "names = {p.name for p in peers}\n"
        "flat = torch.stack([grads[n] for n in sorted(names)])"
    )

    _SINKS = {"stack", "concatenate", "concat", "cat", "hstack", "vstack",
              "tensor", "as_tensor", "sum", "prod", "mean", "all_reduce"}

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for body in _scopes(ctx):
            unordered = self._unordered_names(body)
            for node in iter_scoped_body(body):
                if not isinstance(node, ast.Call):
                    continue
                if terminal_name(node.func) not in self._SINKS:
                    continue
                src = self._unordered_flow(node, unordered)
                if src and not _suppressed(ctx, node, self.name):
                    kind, name = src
                    order = ("hash-seed" if kind == "set"
                             else "set-seeded insertion")
                    out.append(self.finding(
                        ctx, node,
                        f"{terminal_name(node.func)}() consumes iteration "
                        f"over {kind} {name!r} — {order} order is "
                        f"process-dependent, so the reduction order (and "
                        f"its fp result) is too; iterate sorted({name})",
                    ))
        return out

    @staticmethod
    def _unordered_names(body: List[ast.stmt]) -> Dict[str, str]:
        """name -> 'set' | 'dict' for provable in-scope constructions.
        Assignments are replayed in source order (iter_scoped_body is
        unordered) so a set-seeded dict sees its seed."""
        out: Dict[str, str] = {}
        assigns = [n for n in iter_scoped_body(body)
                   if isinstance(n, (ast.Assign, ast.AnnAssign))]
        for node in sorted(assigns, key=lambda n: n.lineno):
            value = node.value
            if value is None:
                continue
            kind = NondetIterationToTensor._unordered_kind(value, out)
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    if kind:
                        out[t.id] = kind
                    else:
                        out.pop(t.id, None)
        return out

    @staticmethod
    def _unordered_kind(expr: ast.expr,
                        known: Dict[str, str]) -> Optional[str]:
        """'set' for hash-ordered values; 'dict' ONLY for dicts whose
        insertion order was seeded by iterating an unordered value (a
        dict comprehension over a set). A plain dict literal/comp over an
        ordered source is insertion-ordered — deterministic — and stays
        untracked."""
        u = NondetIterationToTensor._unordered_kind
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return "set"
        if isinstance(expr, ast.DictComp):
            if any(u(g.iter, known) for g in expr.generators):
                return "dict"
            return None
        if isinstance(expr, ast.Call):
            fn = terminal_name(expr.func)
            if fn == "set" and isinstance(expr.func, ast.Name):
                return "set"
            if fn == "dict" and isinstance(expr.func, ast.Name):
                return ("dict" if expr.args and u(expr.args[0], known)
                        else None)
            if fn in ("keys", "values", "items") \
                    and isinstance(expr.func, ast.Attribute):
                base = expr.func.value
                if isinstance(base, ast.Name) \
                        and known.get(base.id) == "dict":
                    return "dict"
        if isinstance(expr, ast.Name):
            return known.get(expr.id)
        return None

    @staticmethod
    def _unordered_flow(call: ast.Call, unordered: Dict[str, str]
                        ) -> Optional[Tuple[str, str]]:
        """(kind, source name) when an argument iterates an unordered
        value: the value itself, a comprehension over it, or a
        ``.keys()/.values()/.items()`` view of a known dict. ``sorted()``
        anywhere in between launders the order and stays clean."""
        def iter_source(e: ast.expr) -> Optional[Tuple[str, str]]:
            if isinstance(e, ast.Name) and e.id in unordered:
                return unordered[e.id], e.id
            if isinstance(e, ast.Call) \
                    and isinstance(e.func, ast.Attribute) \
                    and e.func.attr in ("keys", "values", "items"):
                base = e.func.value
                if isinstance(base, ast.Name) \
                        and unordered.get(base.id) == "dict":
                    return "dict", base.id
            return None

        for a in call.args:
            direct = iter_source(a)
            if direct:
                return direct
            if isinstance(a, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
                for gen in a.generators:
                    src = iter_source(gen.iter)
                    if src:
                        return src
            if isinstance(a, ast.Call) \
                    and terminal_name(a.func) in ("list", "tuple") \
                    and a.args:
                src = iter_source(a.args[0])
                if src:
                    return src
        return None


class NumBareSuppression(Rule):
    """A ``# numlint: <rule>`` marker without a reason suppresses nothing
    and is itself a finding — suppressions are one-line design docs, same
    contract as the race/hot/lifecycle families. A marker naming a rule
    the family does not have is a typo that would never suppress; flag it
    too."""

    name = "num-bare-suppression"
    family = "num"
    description = (
        "bare or unknown-rule `# numlint:` marker — write `# numlint: "
        "<rule> -- <reason>`"
    )
    example_bad = "g.manual_seed(seed)  # numlint: prng-key-reuse"
    example_good = (
        "g.manual_seed(seed)  "
        "# numlint: prng-key-reuse -- every replica must draw alike"
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        known = {r.name for r in (RULES_INSTANCES or [])} | {"all"}
        for lineno, marks in sorted(_num_suppressions(ctx).items()):
            for rule, reasoned in marks:
                node = ast.Module(body=[], type_ignores=[])
                node.lineno, node.col_offset = lineno, 0  # type: ignore
                if rule not in known:
                    out.append(self.finding(
                        ctx, node,
                        f"`# numlint: {rule}` names no numlint rule — "
                        f"the marker can never suppress anything",
                    ))
                elif not reasoned:
                    out.append(self.finding(
                        ctx, node,
                        "bare `# numlint:` marker — suppressions must "
                        "carry a reason: `# numlint: <rule> -- <why>`",
                    ))
        return out


RULES = [PrngKeyReuse, UnseededRandomness, LowprecAccumulate,
         ImplicitDtypePromotion, NondetIterationToTensor,
         NumBareSuppression]

#: Instantiated once for the bare-suppression rule's known-name check.
RULES_INSTANCES = [cls() for cls in RULES]
