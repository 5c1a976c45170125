"""Hot-path device/host discipline rules (the hotlint family) of the
port: the torch counterpart of :mod:`moolib_tpu.analysis.rules_hot`.

These rules police the host side of the step loop — the discipline the
port's learner keeps: device->host reads are staged asynchronously
(:func:`~moolib_tpu_torch.utils.staging.stage_host_async`, a pinned
non-blocking copy waited for by an event) and drained at log
boundaries, and nothing blocks between an async dispatch and the device
work that could overlap it. One stray ``.item()`` serializes the whole
pipeline.

A **step callable** is a name bound to what the port's step factories
return (``make_impala_train_step``, ``make_grad_step``,
``make_apply_step``, ``make_act_step``; called directly, through a
module attribute, under an import alias, or through a factory def that
returns one — local, or one from-import hop away), or to an
``nn.Module`` instance (``nn.Linear(...)``, or a class whose bases reach
``nn.Module`` locally or one import hop away); plain aliases and
``functools.partial`` wrappers of either stay step callables. A **hot
loop** is a ``for``/``while`` loop that calls one; the values such a
call returns are device values (the taint the rules follow).

``jit-missing-donation`` has no counterpart (:data:`NOT_PORTED`).

The dynamic mirror is :mod:`moolib_tpu_torch.testing.hotwatch`, which
counts the reads that actually happen over a steady-state window; what
these rules cannot see statically (callables crossing module boundaries
as values, reads behind opaque attributes) the runtime gate catches.

Suppression grammar (mirrors racelint): ``# hotlint: sync -- <reason>``
on the offending line acknowledges a sync that is the design (a
checkpoint boundary, an action feed to host envs). The reason is
mandatory — a bare ``# hotlint: sync`` suppresses nothing and is itself
flagged by ``hot-bare-suppression``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .engine import Finding, ModuleContext, Rule, iter_scoped_body
from .engine import terminal_name as _terminal_name
from .rules_bench import is_bench_path
from .rules_jax import _numpy_aliases, _torch_aliases

__all__ = ["NOT_PORTED", "RULES", "STEP_FACTORIES", "step_bindings"]

#: The port's step factories (``moolib_tpu_torch/learner.py``).
STEP_FACTORIES = {"make_impala_train_step", "make_grad_step",
                  "make_apply_step", "make_act_step"}

_HOT_MARKER_RE = re.compile(r"#\s*hotlint:\s*sync\b")
_HOT_REASON_RE = re.compile(r"#\s*hotlint:\s*sync\b[\s:,(–—-]*([^\s)].*)")

_LOOP_NODES = (ast.For, ast.AsyncFor, ast.While)
_FN_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

#: Method names forcing a synchronous device->host read of their tensor.
_MATERIALIZER_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_CASTS = {"float", "int", "bool"}

#: torch constructors whose loop-invariant construction on a device
#: belongs above the loop (an allocation, and an upload, per step).
_TORCH_CONSTRUCTORS = {"zeros", "ones", "full", "empty", "tensor", "arange"}

#: Method names that dispatch async work besides step calls: the
#: Accumulator/Group reductions.
_ASYNC_DISPATCH_METHODS = {"all_reduce", "reduce_gradients"}

#: The port's collectives module: every call into it dispatches.
_COLLECTIVES_MODULE = "collectives"


def _hot_suppressions(ctx: ModuleContext) -> Dict[int, bool]:
    """line -> has_reason for every ``# hotlint: sync`` marker. Only real
    comments count (``ctx.comments`` is tokenize-derived), so markers in
    lint-test fixture strings neither suppress nor trip the bare rule."""
    out: Dict[int, bool] = {}
    for i, text in ctx.comments:
        if "hotlint" not in text:
            continue
        if _HOT_MARKER_RE.search(text):
            m = _HOT_REASON_RE.search(text)
            out[i] = bool(m and m.group(1).strip())
    return out


def _suppressed(ctx: ModuleContext, node: ast.AST,
                sup: Dict[int, bool]) -> bool:
    return bool(sup.get(getattr(node, "lineno", -1)))


def _all_import_bindings(ctx: ModuleContext) -> Dict[str, Tuple[str, str]]:
    """name -> (dotted module, original name) for every from-import in
    the module INCLUDING function-local (lazy) ones — the examples defer
    their learner imports into ``train()``, and the factory resolution
    must still see them. Last-writer wins on collisions, same as the
    interpreter. Memoized on the context."""
    cached = getattr(ctx, "_hot_import_bindings", None)
    if cached is not None:
        return cached
    out: Dict[str, Tuple[str, str]] = {}
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ImportFrom):
            continue
        mod = ctx._absolutize_import(node)
        if mod is None:
            continue
        for alias in node.names:
            if alias.name != "*":
                out[alias.asname or alias.name] = (mod, alias.name)
    ctx._hot_import_bindings = out
    return out


# -- step-callable resolution ---------------------------------------------------


def _nn_aliases(ctx: ModuleContext) -> Set[str]:
    """Names bound to the ``torch.nn`` module (``nn``)."""
    cached = getattr(ctx, "_nn_aliases", None)
    if cached is not None:
        return cached
    out: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "torch.nn" and alias.asname:
                    out.add(alias.asname)
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for alias in node.names:
                if alias.name == "nn":
                    out.add(alias.asname or "nn")
    ctx._nn_aliases = out
    return out


def _is_module_base(ctx: ModuleContext, base: ast.expr) -> bool:
    """``nn.Module`` / ``torch.nn.Module`` / ``Module`` from torch.nn."""
    if isinstance(base, ast.Attribute) and base.attr == "Module":
        v = base.value
        if isinstance(v, ast.Name):
            return v.id in _nn_aliases(ctx)
        return isinstance(v, ast.Attribute) and v.attr == "nn" \
            and isinstance(v.value, ast.Name) \
            and v.value.id in _torch_aliases(ctx)
    if isinstance(base, ast.Name):
        bound = _all_import_bindings(ctx).get(base.id)
        return bound == ("torch.nn", "Module")
    return False


def _module_classes(ctx: ModuleContext) -> Dict[str, ast.ClassDef]:
    cached = getattr(ctx, "_module_classes", None)
    if cached is None:
        cached = ctx._module_classes = {
            n.name: n for n in ctx.tree.body if isinstance(n, ast.ClassDef)}
    return cached


def _is_module_class(ctx: ModuleContext, name: str, depth: int = 3) -> bool:
    """Is ``name`` (as visible from ``ctx``) a class whose bases reach
    ``nn.Module``? Local classes, and one from-import hop into a linted
    module; at most ``depth`` base-class links."""
    if depth <= 0:
        return False
    target_ctx, cls = ctx, _module_classes(ctx).get(name)
    if cls is None:
        bound = _all_import_bindings(ctx).get(name)
        if bound is None:
            return False
        target_ctx = ctx.project.module(bound[0])
        if target_ctx is None:
            return False
        cls = _module_classes(target_ctx).get(bound[1])
        if cls is None:
            return False
    for base in cls.bases:
        if _is_module_base(target_ctx, base):
            return True
        if isinstance(base, ast.Name) and base.id != name \
                and _is_module_class(target_ctx, base.id, depth - 1):
            return True
    return False


def _is_module_ctor(ctx: ModuleContext, call: ast.Call) -> bool:
    """Does ``call`` construct an ``nn.Module``? ``nn.Linear(...)``,
    ``torch.nn.Conv2d(...)``, or a resolvable subclass of it."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr[:1].isupper():
        v = f.value
        if isinstance(v, ast.Name) and v.id in _nn_aliases(ctx):
            return True
        if isinstance(v, ast.Attribute) and v.attr == "nn" \
                and isinstance(v.value, ast.Name) \
                and v.value.id in _torch_aliases(ctx):
            return True
        return False
    return isinstance(f, ast.Name) and _is_module_class(ctx, f.id)


def _is_factory_call(ctx: ModuleContext, call: ast.Call,
                     imports: Dict[str, Tuple[str, str]]) -> bool:
    """A direct call of one of the port's step factories."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr in STEP_FACTORIES
    if isinstance(f, ast.Name):
        bound = imports.get(f.id)
        if bound is not None:
            return bound[1] in STEP_FACTORIES
        return f.id in STEP_FACTORIES
    return False


def _returns_step(ctx: ModuleContext, fn: ast.AST,
                  imports: Dict[str, Tuple[str, str]]) -> bool:
    """Does def ``fn`` return a step callable on every path? Every
    ``return`` (nested defs excluded) must return a factory call, a
    module construction, or a name bound to one in the def."""
    local: Set[str] = set()
    for node in iter_scoped_body(fn.body):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and (_is_factory_call(ctx, node.value, imports)
                     or _is_module_ctor(ctx, node.value)):
            local.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    returns = [n for n in iter_scoped_body(fn.body)
               if isinstance(n, ast.Return)]
    if not returns:
        return False
    for ret in returns:
        v = ret.value
        if isinstance(v, ast.Call) and (_is_factory_call(ctx, v, imports)
                                        or _is_module_ctor(ctx, v)):
            continue
        if isinstance(v, ast.Name) and v.id in local:
            continue
        return False
    return True


def step_bindings(ctx: ModuleContext) -> Set[str]:
    """Every name lexically bound to a step callable anywhere in the
    module (module level or function-local; name-keyed, so rebinding the
    same name across scopes takes last-writer — acceptable for the
    silence-biased rules built on it). Memoized on the context: all five
    structural hot rules start from this set."""
    cached = getattr(ctx, "_hot_step_bindings", None)
    if cached is not None:
        return cached
    imports = _all_import_bindings(ctx)
    local_defs: Dict[str, ast.AST] = {}
    assigns: List[ast.Assign] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, _FN_NODES):
            local_defs.setdefault(node.name, node)
        elif isinstance(node, ast.Assign):
            assigns.append(node)
    returns_step: Dict[int, bool] = {}

    def factory_def(call: ast.Call) -> Optional[Tuple[ModuleContext, ast.AST]]:
        name = call.func.id if isinstance(call.func, ast.Name) else None
        if name is None or name in STEP_FACTORIES:
            return None
        resolved = ctx.project.resolve_function(ctx, name)
        if resolved is not None:
            return resolved
        # Function-local (lazy) imports are invisible to the module
        # symbol table; follow them one hop through the project index.
        bound = imports.get(name)
        if bound is not None:
            target = ctx.project.module(bound[0])
            if target is not None:
                fn = target.top_functions.get(bound[1])
                if fn is not None:
                    return target, fn
            return None
        # Function-local factory defs: look them up lexically.
        fn = local_defs.get(name)
        return None if fn is None else (ctx, fn)

    out: Set[str] = set()
    # Two passes so aliases/partials of names bound later still resolve.
    for _ in range(2):
        for node in assigns:
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if not targets:
                continue
            v = node.value
            step = False
            if isinstance(v, ast.Name):
                step = v.id in out
            elif isinstance(v, ast.Call):
                if _is_factory_call(ctx, v, imports) \
                        or _is_module_ctor(ctx, v):
                    step = True
                elif _terminal_name(v.func) == "partial" and v.args:
                    inner = v.args[0]
                    step = isinstance(inner, ast.Name) and inner.id in out
                else:
                    found = factory_def(v)
                    if found is not None:
                        def_ctx, fn = found
                        if id(fn) not in returns_step:
                            returns_step[id(fn)] = _returns_step(
                                def_ctx, fn, _all_import_bindings(def_ctx))
                        step = returns_step[id(fn)]
            if step:
                out.update(targets)
    ctx._hot_step_bindings = out
    return out


# -- hot loops + device taint -------------------------------------------------


def _loops(ctx: ModuleContext) -> List[ast.AST]:
    return [n for n in ast.walk(ctx.tree) if isinstance(n, _LOOP_NODES)]


def _loop_step_calls(loop: ast.AST, steps: Set[str]) -> List[ast.Call]:
    """Step calls made (lexically) inside the loop body, nested defs
    excluded — they run in their own scope."""
    body = list(loop.body) + list(getattr(loop, "orelse", []))
    return [
        n for n in iter_scoped_body(body)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
        and n.func.id in steps
    ]


def _assigned_names(target: ast.expr) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in target.elts:
            out.extend(_assigned_names(e))
        return out
    return []


def _names_in(expr: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


def _taint_from(value: ast.expr, tainted: Set[str], steps: Set[str]) -> bool:
    """Does assigning from ``value`` propagate device taint? Step-call
    results seed it; plain aliases, subscripts, and attribute loads of a
    tainted name carry it. Arbitrary calls do NOT (their result may be
    anything — silence over guessing)."""
    if isinstance(value, ast.Call):
        return isinstance(value.func, ast.Name) and value.func.id in steps
    if isinstance(value, (ast.Name, ast.Subscript, ast.Attribute)):
        base = value
        while isinstance(base, (ast.Subscript, ast.Attribute)):
            base = base.value
        return isinstance(base, ast.Name) and base.id in tainted
    if isinstance(value, (ast.Tuple, ast.List)):
        return any(_taint_from(e, tainted, steps) for e in value.elts)
    return False


def _device_taint(scope_body: List[ast.stmt], steps: Set[str]) -> Set[str]:
    """Names carrying step-result values anywhere in the scope (eager:
    order-insensitive, because loop bodies re-run — a name tainted at the
    bottom is tainted at the top of the next iteration). Two passes reach
    the alias fixpoint for the chains that occur in practice."""
    tainted: Set[str] = set()
    for _ in range(2):
        for node in iter_scoped_body(scope_body):
            if isinstance(node, ast.Assign):
                if _taint_from(node.value, tainted, steps):
                    for t in node.targets:
                        tainted.update(_assigned_names(t))
    return tainted


#: The staging helpers (``utils/staging.py``): what they return was
#: copied with a pinned non-blocking copy and waited for by an event.
_STAGING = {"stage_host_async", "host_result"}


def _staged_names(scope_body: List[ast.stmt]) -> Set[str]:
    """Names rebound from the staging helpers' results: host-resident
    from there on. Eager taint cannot order the rebinding against the
    step call, so such names are ambiguous — drop them (silence over
    guessing)."""
    out: Set[str] = set()
    for node in iter_scoped_body(scope_body):
        if isinstance(node, ast.Assign) and any(
                isinstance(n, ast.Call) and _terminal_name(n.func) in _STAGING
                for n in ast.walk(node.value)):
            for t in node.targets:
                out.update(_assigned_names(t))
    return out


def _log_boundary(stack: List[ast.AST]) -> bool:
    """Is the innermost enclosing ``if`` a log/drain boundary? The house
    drain pattern gates host reads on a log-cadence test (``now -
    last_log >= log_interval``) — any name mentioning ``log`` or
    ``drain`` in the test exempts the read."""
    for anc in reversed(stack):
        if isinstance(anc, ast.If):
            for n in ast.walk(anc.test):
                name = None
                if isinstance(n, ast.Name):
                    name = n.id
                elif isinstance(n, ast.Attribute):
                    name = n.attr
                if name and ("log" in name.lower()
                             or "drain" in name.lower()):
                    return True
    return False


def _walk_with_ifstack(stmts: List[ast.stmt]):
    """Yield (node, enclosing-if stack) for every node under ``stmts``
    without crossing nested defs — the log-boundary exemption needs the
    ``if`` ancestry that a flat walk loses."""
    def go(node: ast.AST, stack: List[ast.AST]):
        yield node, stack
        if isinstance(node, _FN_NODES + (ast.ClassDef, ast.Lambda)):
            return
        pushed = stack + [node] if isinstance(node, ast.If) else stack
        for child in ast.iter_child_nodes(node):
            yield from go(child, pushed)

    for s in stmts:
        yield from go(s, [])


def _host_read(node: ast.AST, np_aliases: Set[str]) -> Optional[ast.expr]:
    """The expression a host-read call materializes, if ``node`` is one:
    ``x.item()``/``.tolist()``/``.cpu()``/``.numpy()``, ``float(x)``/
    ``int(x)``/``bool(x)``, ``np.asarray(x)``/``np.array(x)``."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Name) and f.id in _HOST_CASTS and node.args:
        return node.args[0]
    if isinstance(f, ast.Attribute) and f.attr in _MATERIALIZER_METHODS:
        return f.value
    if isinstance(f, ast.Attribute) and f.attr in ("asarray", "array") \
            and isinstance(f.value, ast.Name) and f.value.id in np_aliases \
            and node.args:
        return node.args[0]
    return None


# -- rules --------------------------------------------------------------------


class HostTransferInStepLoop(Rule):
    family = "hot"
    name = "host-transfer-in-steploop"
    description = (
        "a step-result tensor is synchronously read on the host (float()/"
        "int()/bool()/.item()/.tolist()/.cpu()/.numpy()/np.asarray()/"
        "f-string interpolation) inside a loop that also calls a step "
        "callable (a step factory's step, or an nn.Module): every "
        "iteration stalls the card's queue on a blocking D2H read. Stage "
        "with utils.stage_host_async and drain at a log boundary, or "
        "acknowledge a designed sync with `# hotlint: sync -- <reason>`."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        steps = step_bindings(ctx)
        if not steps:
            return
        sup = _hot_suppressions(ctx)
        np_aliases = _numpy_aliases(ctx)
        seen: Set[int] = set()
        for loop in _loops(ctx):
            if not _loop_step_calls(loop, steps):
                continue
            body = list(loop.body) + list(getattr(loop, "orelse", []))
            tainted = _device_taint(body, steps) - _staged_names(body)
            if not tainted:
                continue
            for node, ifstack in _walk_with_ifstack(body):
                if id(node) in seen:
                    continue
                msg = self._materializes(node, tainted, np_aliases)
                if msg is None:
                    continue
                if _log_boundary(ifstack) or _suppressed(ctx, node, sup):
                    continue
                seen.add(id(node))
                yield self.finding(ctx, node, msg)

    @staticmethod
    def _materializes(node: ast.AST, tainted: Set[str],
                      np_aliases: Set[str]) -> Optional[str]:
        if isinstance(node, ast.FormattedValue):
            if _names_in(node.value) & tainted:
                return ("f-string interpolation of a step-result tensor "
                        "forces a blocking D2H read each iteration; "
                        "stage it and format at the log boundary")
            return None
        read = _host_read(node, np_aliases)
        if read is not None and _names_in(read) & tainted:
            f = node.func
            if isinstance(f, ast.Name):
                what = f"{f.id}()"
            elif f.attr in _MATERIALIZER_METHODS:
                what = f"`.{f.attr}()`"
            else:
                what = f"{f.value.id}.{f.attr}()"
            return (f"{what} on a step-result tensor blocks the step loop "
                    "on a D2H read; stage via stage_host_async and drain "
                    "at a log boundary")
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "format" \
                and any(_names_in(a) & tainted for a in node.args):
            return ("str.format() of a step-result tensor forces a "
                    "blocking D2H read each iteration; stage it and "
                    "format at the log boundary")
        return None


def _is_cuda_sync(node: ast.Call) -> bool:
    """``torch.cuda.synchronize()``, ``event.synchronize()``,
    ``stream.synchronize()``: every ``.synchronize()`` blocks the host."""
    return isinstance(node.func, ast.Attribute) \
        and node.func.attr == "synchronize"


def _async_dispatch(ctx: ModuleContext, node: ast.Call,
                    imports: Dict[str, Tuple[str, str]]) -> bool:
    """``.to(..., non_blocking=True)``, ``stage_host_async(...)``, a
    ``torch.distributed`` call with ``async_op=True``, a call into the
    port's collectives, or an Accumulator/Group reduction."""
    f = node.func
    for kw in node.keywords:
        if kw.arg in ("non_blocking", "async_op") \
                and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return True
    if _terminal_name(f) == "stage_host_async":
        return True
    if isinstance(f, ast.Attribute):
        if f.attr in _ASYNC_DISPATCH_METHODS:
            return True
        return isinstance(f.value, ast.Name) \
            and f.value.id == _COLLECTIVES_MODULE
    if isinstance(f, ast.Name):
        bound = imports.get(f.id)
        return bound is not None \
            and bound[0].rsplit(".", 1)[-1] == _COLLECTIVES_MODULE
    return False


class SyncInDispatchShadow(Rule):
    family = "hot"
    name = "sync-in-dispatch-shadow"
    description = (
        "a blocking sync (torch.cuda.synchronize()/Event.synchronize()/"
        ".item()) sits lexically between an async dispatch (a step call, "
        ".to(non_blocking=True), stage_host_async, an async_op=True "
        "collective, the port's collectives, an Accumulator/Group "
        "reduction) and its use in the same function: the sync "
        "serializes work that could overlap — dispatch everything "
        "first, then sync. Deliberate timing barriers in bench-scoped "
        "files are exempt."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if is_bench_path(ctx.relpath):
            return  # timing protocols sync between dispatches by design
        steps = step_bindings(ctx)
        imports = _all_import_bindings(ctx)
        sup = _hot_suppressions(ctx)
        bodies: List[List[ast.stmt]] = [ctx.tree.body]
        for node in ast.walk(ctx.tree):
            if isinstance(node, _FN_NODES):
                bodies.append(node.body)
        for body in bodies:
            dispatch_lines: List[int] = []
            use_lines: List[int] = []
            dispatched: Set[str] = set()
            syncs: List[Tuple[ast.AST, List[ast.AST]]] = []
            for node in iter_scoped_body(body):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Call) \
                        and _async_dispatch(ctx, node.value, imports):
                    for t in node.targets:
                        dispatched.update(_assigned_names(t))
            for node, ifstack in _walk_with_ifstack(body):
                line = getattr(node, "lineno", 0)
                if isinstance(node, ast.Name) \
                        and isinstance(node.ctx, ast.Load) \
                        and node.id in dispatched:
                    use_lines.append(line)
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Name) and f.id in steps:
                    dispatch_lines.append(line)
                    use_lines.append(line)
                elif _async_dispatch(ctx, node, imports):
                    dispatch_lines.append(line)
                elif _is_cuda_sync(node) or (
                        isinstance(f, ast.Attribute) and f.attr == "item"
                        and not node.args):
                    syncs.append((node, ifstack))
            for node, ifstack in syncs:
                line = getattr(node, "lineno", 0)
                if not any(d < line for d in dispatch_lines):
                    continue
                if not any(u > line for u in use_lines):
                    continue  # final sync before leaving: legitimate
                if _log_boundary(ifstack) or _suppressed(ctx, node, sup):
                    continue
                what = ("torch.cuda.synchronize()" if _is_cuda_sync(node)
                        and _terminal_name(node.func.value) == "cuda"
                        else f".{node.func.attr}()")
                yield self.finding(
                    ctx, node,
                    f"{what} between an async dispatch and its use "
                    "serializes the overlap; move the sync after the last "
                    "dispatch (or drop it and let stream order the work)",
                )


class DeviceAllocInStepLoop(Rule):
    family = "hot"
    name = "device-alloc-in-steploop"
    description = (
        "a torch constructor on a device (torch.zeros/ones/full/empty/"
        "tensor/arange(..., device=...)) with loop-invariant arguments "
        "runs inside a hot loop: every iteration pays an allocation (and, "
        "for torch.tensor, an upload) for a value that never changes. "
        "Hoist it above the loop."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        steps = step_bindings(ctx)
        torch_names = _torch_aliases(ctx)
        if not steps or not torch_names:
            return
        sup = _hot_suppressions(ctx)
        for loop in _loops(ctx):
            if not _loop_step_calls(loop, steps):
                continue
            body = list(loop.body) + list(getattr(loop, "orelse", []))
            stored: Set[str] = set(_assigned_names(getattr(
                loop, "target", ast.Tuple(elts=[]))))
            for node in iter_scoped_body(body):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        stored.update(_assigned_names(t))
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    stored.update(_assigned_names(node.target))
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    stored.update(_assigned_names(node.target))
                elif isinstance(node, ast.comprehension):
                    stored.update(_assigned_names(node.target))
                elif isinstance(node, ast.NamedExpr):
                    stored.update(_assigned_names(node.target))
                elif isinstance(node, ast.withitem) \
                        and node.optional_vars is not None:
                    stored.update(_assigned_names(node.optional_vars))
            for node in iter_scoped_body(body):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if not (isinstance(f, ast.Attribute)
                        and f.attr in _TORCH_CONSTRUCTORS
                        and isinstance(f.value, ast.Name)
                        and f.value.id in torch_names):
                    continue
                if not any(kw.arg == "device" for kw in node.keywords):
                    continue  # a host tensor: not a device allocation
                operands = list(node.args) \
                    + [kw.value for kw in node.keywords]
                invariant = all(
                    not any(isinstance(n, ast.Call)
                            for n in ast.walk(op))
                    and not (_names_in(op) & stored)
                    for op in operands
                )
                if invariant and not _suppressed(ctx, node, sup):
                    yield self.finding(
                        ctx, node,
                        f"{f.value.id}.{f.attr}(..., device=...) with "
                        "loop-invariant arguments allocates the same "
                        "constant every iteration; hoist it above the "
                        "loop",
                    )


def _keyed_by_loop_var(loop: ast.AST) -> bool:
    """Does the loop body index its iterable by the loop variable
    (``for k in m: m[k]``)? Then the iterable is a mapping — the port's
    steps return metrics and gradients as dicts — and iterating its keys
    reads nothing from the card."""
    keys = set(_assigned_names(loop.target))
    name = loop.iter.id
    return any(isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name)
               and n.value.id == name and isinstance(n.slice, ast.Name)
               and n.slice.id in keys
               for n in iter_scoped_body(list(loop.body)))


class PythonLoopOverDeviceArray(Rule):
    family = "hot"
    name = "python-loop-over-device-array"
    description = (
        "Python-level for-iteration over a step-result tensor (or "
        "per-element indexing of one by a range() loop variable): each "
        "element is a separate device read and the loop body runs "
        "un-fused on the host. Use tensor ops over the whole tensor (or "
        "read it once, outside the hot path). A mapping iterated by key "
        "(the body indexes it with the loop variable) is exempt: the "
        "steps return metrics and gradients as dicts."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        steps = step_bindings(ctx)
        if not steps:
            return
        sup = _hot_suppressions(ctx)
        np_aliases = _numpy_aliases(ctx)
        bodies: List[List[ast.stmt]] = [ctx.tree.body]
        for node in ast.walk(ctx.tree):
            if isinstance(node, _FN_NODES):
                bodies.append(node.body)
        for body in bodies:
            tainted = _device_taint(body, steps)
            if not tainted:
                continue
            # A name rebound through a host read is host-resident from
            # there on; eager taint cannot order the two, so such names
            # are ambiguous — drop them (silence over guessing).
            for node in iter_scoped_body(body):
                if isinstance(node, ast.Assign) \
                        and _host_read(node.value, np_aliases) is not None:
                    for t in node.targets:
                        tainted.difference_update(_assigned_names(t))
            if not tainted:
                continue
            for node in iter_scoped_body(body):
                if isinstance(node, (ast.For, ast.AsyncFor)) \
                        and isinstance(node.iter, ast.Name) \
                        and node.iter.id in tainted \
                        and not _keyed_by_loop_var(node) \
                        and not _suppressed(ctx, node, sup):
                    yield self.finding(
                        ctx, node,
                        f"Python for-loop iterates step-result tensor "
                        f"{node.iter.id!r} element by element; tensor ops "
                        "keep it on the card (or read it once with "
                        ".cpu() outside the hot path)",
                    )
                elif isinstance(node, (ast.For, ast.AsyncFor)) \
                        and isinstance(node.iter, ast.Call) \
                        and _terminal_name(node.iter.func) == "range":
                    loop_vars = set(_assigned_names(node.target))
                    if not loop_vars:
                        continue
                    for sub in iter_scoped_body(list(node.body)):
                        if isinstance(sub, ast.Subscript) \
                                and isinstance(sub.value, ast.Name) \
                                and sub.value.id in tainted \
                                and isinstance(sub.slice, ast.Name) \
                                and sub.slice.id in loop_vars \
                                and not _suppressed(ctx, sub, sup):
                            yield self.finding(
                                ctx, sub,
                                f"per-element indexing of step-result "
                                f"tensor {sub.value.id!r} by the loop "
                                "variable reads the card once per "
                                "element; tensor ops (or one bulk .cpu()) "
                                "replace the loop",
                            )
                            break  # one finding per loop


class HotBareSuppression(Rule):
    family = "hot"
    name = "hot-bare-suppression"
    description = (
        "`# hotlint: sync` without a reason: the marker exists to record "
        "WHY a sync is the design (checkpoint boundary, host env feed). "
        "Write `# hotlint: sync -- <reason>`; a bare marker suppresses "
        "nothing."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for line, has_reason in sorted(_hot_suppressions(ctx).items()):
            if not has_reason:
                yield Finding(
                    path=ctx.relpath, line=line, col=0, rule=self.name,
                    message="bare `# hotlint: sync` marker: add the "
                            "reason (`# hotlint: sync -- <why this sync "
                            "is the design>`) or remove it",
                    snippet=ctx.line(line).strip(),
                )


RULES = [HostTransferInStepLoop, SyncInDispatchShadow,
         DeviceAllocInStepLoop, PythonLoopOverDeviceArray,
         HotBareSuppression]

#: Reference rules of this family without a torch counterpart.
NOT_PORTED: Dict[str, str] = {
    "jit-missing-donation": (
        "torch has no buffer donation: the port's apply step updates the "
        "parameters and optimizer state in place (learner.py, "
        "make_apply_step), so a threaded state never holds two "
        "generations of its buffers."
    ),
}
