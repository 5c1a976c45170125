"""Async-RPC safety rules.

The invariants come straight from the RPC core's architecture (one asyncio
loop per ``Rpc`` on a dedicated IO thread, user code bridged via
``run_coroutine_threadsafe`` and ``concurrent.futures`` callbacks — see
``moolib_tpu_torch/rpc/rpc.py``):

- cancellation must never be swallowed: an ``asyncio.CancelledError`` eaten
  by a broad ``except`` wedges round bookkeeping during elastic membership
  changes (``swallow-cancelled``);
- nothing may block the IO loop (``async-blocking-call``);
- thread locks must not be held across ``await`` (``lock-held-across-await``);
- every coroutine must be awaited or scheduled (``unawaited-coroutine``);
- futures carry exceptions — dropping one on the floor loses them
  (``dropped-future``).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from .engine import Finding, ModuleContext, Rule, iter_scoped_body
from .engine import terminal_name as _terminal_name

__all__ = ["RULES"]

_BROAD = {"Exception", "BaseException"}


def _exc_names(type_node: Optional[ast.expr]) -> List[str]:
    if type_node is None:
        return []
    if isinstance(type_node, ast.Tuple):
        return [n for e in type_node.elts
                for n in ([_terminal_name(e)] if _terminal_name(e) else [])]
    n = _terminal_name(type_node)
    return [n] if n else []


def _is_broad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True  # bare except
    return any(n in _BROAD for n in _exc_names(handler.type))


def _catches_cancelled(handler: ast.ExceptHandler) -> bool:
    return any(n == "CancelledError" for n in _exc_names(handler.type))


# All nodes under a statement list, not descending into nested function/
# class definitions or lambdas (their bodies run in a different context).
# The engine-shared walk — kept under the historical local name.
_stmts_no_nested_defs = iter_scoped_body


def _reraises(handler: ast.ExceptHandler) -> bool:
    """Handler body re-raises the caught exception (bare ``raise`` or
    ``raise <caught name>``)."""
    for node in _stmts_no_nested_defs(handler.body):
        if isinstance(node, ast.Raise):
            if node.exc is None:
                return True
            if (handler.name and isinstance(node.exc, ast.Name)
                    and node.exc.id == handler.name):
                return True
    return False


class SwallowCancelled(Rule):
    name = "swallow-cancelled"
    description = (
        "broad `except` (bare / Exception / BaseException) with no "
        "re-raise and no preceding `except CancelledError: raise` guard "
        "can swallow task cancellation — which wedges round bookkeeping "
        "during elastic membership changes. Applies to concurrency-bearing "
        "modules (asyncio/threading/concurrent imports or async defs)."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not (ctx.has_async_def()
                or ctx.imports_any("asyncio", "threading", "concurrent")):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            guarded = False
            for handler in node.handlers:
                if _catches_cancelled(handler) and _reraises(handler):
                    guarded = True  # covers every LATER broad handler
                    continue
                if guarded or not _is_broad(handler):
                    continue
                if _reraises(handler):
                    continue
                yield self.finding(
                    ctx, handler,
                    "broad except may swallow CancelledError; add "
                    "`except asyncio.CancelledError: raise` before it "
                    "(restoring any bookkeeping first) or re-raise",
                )


# Callable patterns that block the calling thread. Each entry:
# (predicate(Call) -> bool, message).
def _is_time_sleep(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "sleep"
            and isinstance(f.value, ast.Name) and f.value.id == "time")


def _is_untimed_result(call: ast.Call) -> bool:
    f = call.func
    if not (isinstance(f, ast.Attribute)
            and f.attr in ("result", "exception")):
        return False
    has_timeout = bool(call.args) or any(
        kw.arg == "timeout" for kw in call.keywords
    )
    return not has_timeout


def _is_sync_open(call: ast.Call) -> bool:
    return isinstance(call.func, ast.Name) and call.func.id == "open"


_SUBPROCESS_FNS = {"run", "call", "check_call", "check_output", "getoutput"}
_SOCKET_MODULES = {"socket", "pysocket"}
_REQUESTS_FNS = {"get", "post", "put", "delete", "head", "patch", "request"}


def _is_subprocess(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr in _SUBPROCESS_FNS
            and isinstance(f.value, ast.Name)
            and f.value.id in ("subprocess", "os"))


def _is_sync_socket(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute)
            and f.attr in ("create_connection", "getaddrinfo",
                           "gethostbyname")
            and isinstance(f.value, ast.Name)
            and f.value.id in _SOCKET_MODULES)


def _is_requests(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr in _REQUESTS_FNS
            and isinstance(f.value, ast.Name) and f.value.id == "requests")


_BLOCKING = [
    (_is_time_sleep,
     "time.sleep() blocks the IO loop; use `await asyncio.sleep()`"),
    (_is_untimed_result,
     "Future .result()/.exception() with no timeout blocks the IO loop; "
     "await the future or pass a timeout"),
    (_is_sync_open,
     "synchronous file IO inside `async def` blocks the IO loop; "
     "do it on an executor"),
    (_is_subprocess,
     "blocking subprocess/os call inside `async def`; use "
     "asyncio.create_subprocess_* or an executor"),
    (_is_sync_socket,
     "blocking socket operation inside `async def`; use the loop's "
     "async connection APIs"),
    (_is_requests,
     "blocking HTTP call inside `async def`; use an async client or "
     "an executor"),
]


class AsyncBlockingCall(Rule):
    name = "async-blocking-call"
    description = (
        "blocking call (time.sleep, untimed Future.result()/.exception(), "
        "sync file/socket/subprocess/HTTP IO) directly inside an "
        "`async def` body stalls every connection on the event loop."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in _stmts_no_nested_defs(fn.body):
                if not isinstance(node, ast.Call):
                    continue
                for pred, msg in _BLOCKING:
                    if pred(node):
                        yield self.finding(ctx, node, msg)
                        break


_LOCKISH = ("lock", "cond", "mutex", "sem")
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}


def _is_lockish(expr: ast.expr) -> bool:
    name = _terminal_name(expr)
    if name and any(t in name.lower() for t in _LOCKISH):
        return True
    if isinstance(expr, ast.Call):
        ctor = _terminal_name(expr.func)
        return ctor in _LOCK_CTORS
    return False


class LockHeldAcrossAwait(Rule):
    name = "lock-held-across-await"
    description = (
        "a synchronous `with <lock>` whose body awaits holds a thread lock "
        "across a suspension point: every other thread (and any loop "
        "callback taking the lock) deadlocks against arbitrary-length "
        "awaits. Release before awaiting, or use an asyncio lock."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in _stmts_no_nested_defs(fn.body):
                if not isinstance(node, ast.With):
                    continue
                if not any(_is_lockish(i.context_expr) for i in node.items):
                    continue
                if any(isinstance(n, ast.Await)
                       for n in _stmts_no_nested_defs(node.body)):
                    yield self.finding(
                        ctx, node,
                        "thread lock held across `await`; release it "
                        "before suspending or use asyncio.Lock",
                    )


class UnawaitedCoroutine(Rule):
    name = "unawaited-coroutine"
    description = (
        "calling a module-local `async def` as a bare statement creates a "
        "coroutine object and throws it away — the code never runs. "
        "Await it, or hand it to create_task()/run_coroutine_threadsafe()."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        async_names: Set[str] = {
            n.name for n in ast.walk(ctx.tree)
            if isinstance(n, ast.AsyncFunctionDef)
        }
        if not async_names:
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Call)):
                continue
            callee = _terminal_name(node.value.func)
            if callee in async_names:
                yield self.finding(
                    ctx, node,
                    f"coroutine {callee!r} is created but never awaited "
                    "or scheduled",
                )


_FUTURE_PRODUCERS = {"run_coroutine_threadsafe", "ensure_future", "submit"}


class DroppedFuture(Rule):
    name = "dropped-future"
    description = (
        "the Future returned by run_coroutine_threadsafe / ensure_future / "
        "executor.submit is discarded: any exception in the scheduled work "
        "is silently lost. Keep a reference and consume its result, or "
        "attach an error-logging callback."
    )

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Call)):
                continue
            callee = _terminal_name(node.value.func)
            if callee in _FUTURE_PRODUCERS:
                yield self.finding(
                    ctx, node,
                    f"Future returned by {callee}() dropped on the floor; "
                    "exceptions in it are silently lost",
                )


RULES = [
    SwallowCancelled,
    AsyncBlockingCall,
    LockHeldAcrossAwait,
    UnawaitedCoroutine,
    DroppedFuture,
]
