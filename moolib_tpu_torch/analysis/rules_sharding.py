"""Mesh/collective consistency rules of the port: the torch counterpart
of :mod:`moolib_tpu.analysis.rules_sharding`.

The failure class: a collective over an axis name the mesh does not
have, or a sharding spec naming an absent axis, fails only when the
program first runs on a real multi-device mesh (``DeviceMesh.get_group``
raises, or a spec shards the wrong dimension). These rules catch the
statically-decidable instances before any card hour is burned.

Axis names resolve through the interprocedural layer in :mod:`engine`:

- a mesh's axes come from ``DeviceMesh(..., mesh_dim_names=...)`` and
  ``init_device_mesh(..., mesh_dim_names=...)`` (a literal, or a name
  bound to one — ``parallel/mesh.py``'s ``AXES``), a one-axis slice
  ``mesh["dp"]``, and up to two named-call hops (so ``make_mesh`` from
  ``parallel/mesh.py`` resolves when that module is part of the lint
  run);
- the mesh *in scope* for a collective is the mesh argument of the call
  itself (the port's collectives take ``(x, mesh, ..., axis_name)``, as
  ``parallel/collectives.py`` defines them); for a spec builder that
  takes no mesh (``batch_leaf_spec``, ``batch_specs``) it is the one mesh
  the enclosing scopes build.

Everything is strictly best-effort: an unresolvable mesh, a computed
spec, or a variable axis name silences the check — these rules only
speak when the violation is provable from literals.

``donated-buffer-reuse`` and ``pallas-blockspec-static`` have no
counterpart (:data:`NOT_PORTED`).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

from .engine import (
    Finding,
    ModuleContext,
    Rule,
    iter_scoped,
    iter_scoped_body,
    terminal_name as _terminal_name,
)
from .rules_hot import _COLLECTIVES_MODULE, _all_import_bindings

__all__ = ["NOT_PORTED", "RULES"]

#: The port's collectives (``parallel/collectives.py``): name -> (mesh
#: position, axis position) of their positional parameters.
_COLLECTIVES = {
    "psum": (1, 2), "pmean": (1, 2), "all_to_all": (1, 2),
    "ppermute": (1, 3), "ppermute_many": (1, 3),
    "axis_group": (0, 1), "axis_size": (0, 1), "axis_index": (0, 1),
}

_MESH_CTORS = {"DeviceMesh": 2, "init_device_mesh": 2}  # names' position
_SPEC_BUILDERS = {"batch_leaf_spec": 2, "batch_specs": 2}  # axis position

# Mesh-returning call chains are followed this many named hops
# (make_mesh -> DeviceMesh is one; a helper -> make_mesh -> DeviceMesh is
# two).
_MESH_HOPS = 2


def _literal_strs(node: Optional[ast.expr]) -> Optional[List[str]]:
    """["a", "b"] for a literal str / tuple-or-list of strs; None if any
    element is not a string literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return out
    return None


def _kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _arg(call: ast.Call, name: str, pos: int) -> Optional[ast.expr]:
    """The argument bound to parameter ``name`` at position ``pos``."""
    kw = _kwarg(call, name)
    if kw is not None:
        return kw
    if pos < len(call.args) and not any(isinstance(a, ast.Starred)
                                        for a in call.args[:pos + 1]):
        return call.args[pos]
    return None


class _Resolver:
    """Name/mesh resolution against enclosing function scopes, the module
    symbol table, and the project index."""

    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx

    def lookup(self, name: str, fn_stack: Sequence[ast.AST],
               before_line: Optional[int] = None) -> Optional[ast.expr]:
        """The value expression last assigned to ``name`` AT OR BEFORE the
        use site (lexical approximation): a rebinding later in the scope
        must not retroactively change earlier checks. With no position
        given, the last assignment in the scope wins."""
        scopes: List[Iterable[ast.AST]] = [
            iter_scoped(fn) for fn in reversed(list(fn_stack))
        ]
        scopes.append(iter_scoped_body(self.ctx.tree.body))
        for nodes in scopes:
            found: Optional[ast.stmt] = None
            for n in nodes:
                value: Optional[ast.expr] = None
                if isinstance(n, ast.Assign):
                    if any(isinstance(t, ast.Name) and t.id == name
                           for t in n.targets):
                        value = n.value
                elif isinstance(n, ast.AnnAssign) and n.value is not None:
                    if isinstance(n.target, ast.Name) \
                            and n.target.id == name:
                        value = n.value
                if value is None:
                    continue
                if before_line is not None and n.lineno > before_line:
                    continue
                if found is None or n.lineno >= found.lineno:
                    found = n
            if found is not None:
                return found.value
        return None

    def local_function(self, name: str,
                       fn_stack: Sequence[ast.AST]) -> Optional[ast.AST]:
        """A def named ``name`` visible from the innermost scope."""
        for fn in reversed(list(fn_stack)):
            for n in iter_scoped(fn):
                if n is not fn and isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                        ast.ClassDef)
                ):
                    continue  # its children live in a deeper scope
                for child in ast.iter_child_nodes(n):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)) \
                            and child.name == name:
                        return child
        return self.ctx.top_functions.get(name)

    def resolve_callee(self, name: str, fn_stack: Sequence[ast.AST]
                       ) -> Optional[Tuple[ModuleContext, ast.AST]]:
        local = self.local_function(name, fn_stack)
        if local is not None:
            return self.ctx, local
        return self.ctx.project.resolve_function(self.ctx, name)

    def strs(self, expr: Optional[ast.expr], fn_stack: Sequence[ast.AST]
             ) -> Optional[List[str]]:
        """Literal strings of ``expr``, through one name binding."""
        if isinstance(expr, ast.Name):
            expr = self.lookup(expr.id, fn_stack,
                               before_line=getattr(expr, "lineno", None))
        return _literal_strs(expr)

    # -- mesh axis names -----------------------------------------------------

    def mesh_axes(self, expr: Optional[ast.expr],
                  fn_stack: Sequence[ast.AST],
                  hops: int = _MESH_HOPS,
                  _seen: Optional[Set[int]] = None) -> Optional[frozenset]:
        """Axis names of the mesh ``expr`` evaluates to, or None when the
        construction cannot be traced to literals."""
        if expr is None:
            return None
        _seen = set() if _seen is None else _seen
        if id(expr) in _seen:
            return None  # assignment cycle (a = b; b = a)
        _seen.add(id(expr))
        if isinstance(expr, ast.Name):
            value = self.lookup(expr.id, fn_stack,
                                before_line=getattr(expr, "lineno", None))
            if value is not None and value is not expr:
                return self.mesh_axes(value, fn_stack, hops, _seen)
            return None
        if isinstance(expr, ast.Subscript):
            # mesh["dp"] / mesh["dp", "tp"]: a slice over those axes.
            names = _literal_strs(expr.slice)
            return frozenset(names) if names else None
        if isinstance(expr, ast.Call):
            axes = self._ctor_axes(expr, fn_stack)
            if axes is not None:
                return axes
            if hops <= 0:
                return None
            callee = _terminal_name(expr.func)
            if callee is None or callee in _MESH_CTORS:
                return None
            resolved = self.resolve_callee(callee, fn_stack)
            if resolved is None:
                return None
            def_ctx, fn = resolved
            return _Resolver(def_ctx)._function_mesh_axes(fn, hops - 1)
        return None

    def _ctor_axes(self, call: ast.Call,
                   fn_stack: Sequence[ast.AST]) -> Optional[frozenset]:
        pos = _MESH_CTORS.get(_terminal_name(call.func))
        if pos is None:
            return None
        names = self.strs(_arg(call, "mesh_dim_names", pos), fn_stack)
        return frozenset(names) if names else None

    def _function_mesh_axes(self, fn: ast.AST,
                            hops: int) -> Optional[frozenset]:
        """Axes of the mesh a function builds: a single resolvable mesh
        constructor anywhere in its body, else a returned named call
        followed one more hop. Ambiguity (two different meshes) resolves
        to None."""
        found: Set[frozenset] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Call):
                axes = self._ctor_axes(n, [fn])
                if axes is not None:
                    found.add(axes)
        if len(found) == 1:
            return next(iter(found))
        if found:
            return None
        for n in iter_scoped(fn):
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Call):
                axes = self.mesh_axes(n.value, [fn], hops)
                if axes is not None:
                    return axes
        return None

    def scope_mesh(self, fn_stack: Sequence[ast.AST]) -> Optional[frozenset]:
        """The one mesh the enclosing scopes (innermost first, then the
        module) assign to a name; None when there is none or two
        differ."""
        for scope in [list(iter_scoped(fn)) for fn in reversed(
                list(fn_stack))] + [list(iter_scoped_body(
                    self.ctx.tree.body))]:
            found: Set[frozenset] = set()
            for n in scope:
                if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                    axes = self.mesh_axes(n.value, fn_stack)
                    if axes is not None:
                        found.add(axes)
            if len(found) == 1:
                return next(iter(found))
            if found:
                return None
        return None


def _walk_with_fn_stack(tree: ast.AST) -> Iterator[Tuple[ast.AST, List[ast.AST]]]:
    """(node, enclosing-function-stack) for every node, outermost first."""

    def rec(node: ast.AST, stack: List[ast.AST]):
        yield node, stack
        is_fn = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda))
        nxt = stack + [node] if is_fn else stack
        for child in ast.iter_child_nodes(node):
            yield from rec(child, nxt)

    yield from rec(tree, [])


def _collective_name(ctx: ModuleContext, call: ast.Call,
                     imports: Dict[str, Tuple[str, str]]) -> Optional[str]:
    """The port collective ``call`` invokes: ``collectives.psum(...)``, or
    a name from-imported out of a ``collectives`` module."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _COLLECTIVES \
            and isinstance(f.value, ast.Name) \
            and f.value.id == _COLLECTIVES_MODULE:
        return f.attr
    if isinstance(f, ast.Name):
        bound = imports.get(f.id)
        if bound is not None and bound[1] in _COLLECTIVES \
                and bound[0].rsplit(".", 1)[-1] == _COLLECTIVES_MODULE:
            return bound[1]
    return None


def _params(fn: ast.AST) -> List[str]:
    args = fn.args
    return [a.arg for a in list(args.posonlyargs) + list(args.args)]


def _helper_consumes_axis(def_ctx: ModuleContext, fn: ast.AST) -> bool:
    """True when helper ``fn`` takes ``mesh`` and ``axis_name`` and
    forwards both into a collective, or into another call's
    ``axis_name``: only then does a literal axis the caller passes have
    to exist on the caller's mesh."""
    names = set(_params(fn)) | {a.arg for a in fn.args.kwonlyargs}
    if not {"mesh", "axis_name"} <= names:
        return False
    imports = _all_import_bindings(def_ctx)
    for n in iter_scoped(fn):
        if not isinstance(n, ast.Call):
            continue
        coll = _collective_name(def_ctx, n, imports)
        if coll is not None:
            axis = _arg(n, "axis_name", _COLLECTIVES[coll][1])
        else:
            axis = _kwarg(n, "axis_name")
            if axis is None and len(n.args) >= 3 \
                    and isinstance(n.args[1], ast.Name) \
                    and n.args[1].id == "mesh":
                axis = n.args[2]  # (x, mesh, axis_name) helper shape
        if isinstance(axis, ast.Name) and axis.id == "axis_name":
            return True
    return False


class CollectiveAxisUnbound(Rule):
    name = "collective-axis-unbound"
    description = (
        "a collective of parallel/collectives.py (psum/pmean/all_to_all/"
        "ppermute/ppermute_many/axis_group/axis_size/axis_index) names a "
        "literal axis_name its mesh does not have — DeviceMesh.get_group "
        "raises only when the program first runs on the real mesh. "
        "Literal `axis_name=` kwargs to helpers that take the mesh are "
        "checked too, when the helper resolvably forwards the axis into "
        "a collective."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        resolver = _Resolver(ctx)
        imports = _all_import_bindings(ctx)
        for node, stack in _walk_with_fn_stack(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            coll = _collective_name(ctx, node, imports)
            if coll is not None:
                mesh_pos, axis_pos = _COLLECTIVES[coll]
                lits = _literal_strs(_arg(node, "axis_name", axis_pos))
                if not lits:
                    continue
                axes = resolver.mesh_axes(_arg(node, "mesh", mesh_pos), stack)
                if axes is None:
                    continue
                for axis in lits:
                    if axis not in axes:
                        yield self.finding(
                            ctx, node,
                            f"collective names axis {axis!r} but its mesh "
                            f"has only {sorted(axes)}",
                        )
                continue
            kw = _kwarg(node, "axis_name")
            lits = _literal_strs(kw) if kw is not None else None
            callee = _terminal_name(node.func)
            if not lits or callee is None or callee in _SPEC_BUILDERS:
                continue
            resolved = resolver.resolve_callee(callee, stack)
            if resolved is None or not _helper_consumes_axis(*resolved):
                continue  # cannot see into the helper: stay silent
            params = _params(resolved[1])
            mesh_expr = _arg(node, "mesh", params.index("mesh")) \
                if "mesh" in params else _kwarg(node, "mesh")
            axes = resolver.mesh_axes(mesh_expr, stack)
            if axes is None:
                continue
            for axis in lits:
                if axis not in axes:
                    yield self.finding(
                        ctx, node,
                        f"helper call passes axis_name={axis!r} but its "
                        f"mesh has only {sorted(axes)}",
                    )


class PartitionSpecAxisUnbound(Rule):
    name = "pspec-axis-unbound"
    description = (
        "a sharding spec names a mesh axis the mesh does not have: a "
        "spec tuple given to parallel/mesh.py's placements(mesh, spec), "
        "or a literal axis_name= given to batch_leaf_spec/batch_specs "
        "(checked against the one mesh the enclosing scopes build) — "
        "the sharding fails only when it first runs on the real mesh."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        resolver = _Resolver(ctx)
        for node, stack in _walk_with_fn_stack(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _terminal_name(node.func)
            if name == "placements":
                axes = resolver.mesh_axes(_arg(node, "mesh", 0), stack)
                spec = _arg(node, "spec", 1)
                if axes is None or spec is None:
                    continue
                if isinstance(spec, ast.Name):
                    spec = resolver.lookup(
                        spec.id, stack, before_line=spec.lineno) or spec
                if not isinstance(spec, (ast.Tuple, ast.List)):
                    continue
                for e in spec.elts:
                    if isinstance(e, ast.Constant) \
                            and isinstance(e.value, str) \
                            and e.value not in axes:
                        yield self.finding(
                            ctx, e,
                            f"spec names axis {e.value!r} but the mesh has "
                            f"only {sorted(axes)}",
                        )
            elif name in _SPEC_BUILDERS:
                lits = _literal_strs(
                    _arg(node, "axis_name", _SPEC_BUILDERS[name]))
                if not lits:
                    continue
                axes = resolver.scope_mesh(stack)
                if axes is None:
                    continue
                for axis in lits:
                    if axis not in axes:
                        yield self.finding(
                            ctx, node,
                            f"{name} shards over axis {axis!r} but the "
                            f"mesh in scope has only {sorted(axes)}",
                        )


RULES = [CollectiveAxisUnbound, PartitionSpecAxisUnbound]

#: Reference rules of this family without a torch counterpart.
NOT_PORTED: Dict[str, str] = {
    "donated-buffer-reuse": (
        "torch has no buffer donation: no call of the port hands its "
        "argument's storage to its output, so a name read after a step "
        "call still holds live data (the apply step updates in place)."
    ),
    "pallas-blockspec-static": (
        "the port has no Pallas: its kernels are hand-written CUDA whose "
        "wrappers check every shape, dtype and tile at launch "
        "(ops/_kernels.py, _check_attention)."
    ),
}
