"""CL001/CL002 — lock discipline for the port's serving stack and kernels.

CL001 (lock-blocking-call): the pump's bounded-latency contract is that
claiming work happens under ``session.lock`` while packing/executing/
blocking happens OUTSIDE it.  Any blocking or compute call inside a
``with <x>.lock`` / ``with <x>._lock`` body stalls every other thread
contending for that lock (admission, slot-join, stats readers).  On a
card the ways to block are more than the reference's: a host sync
(``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
``torch.cuda.synchronize``, an event's or stream's ``.synchronize()``)
waits for every kernel queued before it, and a first-use build of the
kernel library (``_build.build`` / ``load_library``, ``ctypes.CDLL``,
``subprocess.*``) runs nvcc for seconds.  The build lock exists to
serialise exactly that build, so the build calls are allowed under it
and under nothing else.

CL002 (lock-order-cycle): a static acquisition-order graph over the
serving locks (``session.lock``, ``router._lock``,
``TransferBufferPool._lock``, the injectors' locks) and the kernel
module's two module-level locks (``_build._lock``, node ``build``;
``_build.launch_lock``, node ``launch``, however it is spelt).  Nested
acquisitions and one level of call resolution (methods of the serving
classes, module-level functions such as ``_build.count_launch``) produce
edges; any cycle is a potential deadlock.  ``session.lock`` is an RLock,
so session->session reacquisition (pump.submit -> session.submit) is
legal and exempt.

Scope: ``src/repro_torch/`` only — test doubles build whatever lock
shapes the scenario needs.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Finding, ParsedFile, dotted_name, \
    in_port, iter_functions, module_name
from repro_torch.analysis.recompile import library_build_site

RULES = {
    "CL001": "blocking call (host sync, kernel build, wait) inside a "
             "with-lock body",
    "CL002": "cycle in the static lock-acquisition-order graph",
}

# Calls that block or do batch compute; none may run under a serving lock.
# `.join` is only flagged with zero positional args (``t.join()``), which
# separates Thread.join from the ubiquitous ``", ".join(parts)``.
BLOCKED_ATTRS = {
    "result", "wait", "sleep", "_sleep", "join",
    "pack_chunk", "execute_chunk", "pack_requests", "rank_batch",
    "_execute_attempt", "_execute_with_retry", "run_chunk",
    "warmup", "warm_restart",
}
# Host syncs: each waits for the device to finish what was queued before.
HOST_SYNC_ATTRS = {"item", "cpu", "tolist", "numpy", "synchronize"}
# Building or loading the kernel library (nvcc runs for seconds): _build's
# own entry points, and any library build or load (recompile.py's list).
BUILD_CALLS = {"_build.build", "_build.load_library", "load_library"}
# The lock whose job is to serialise that build.
BUILD_NODE = "build"

# Canonical lock-node names for the serving classes...
_CLASS_NODE = {
    "CascadeSession": "session",
    "SessionPump": "pump",
    "ReplicaRouter": "router",
    "TransferBufferPool": "pool",
    "RequestBatcher": "pool",
    "FaultInjector": "injector",
    "FsFaultInjector": "injector",
}
# ... and for the receiver names the serving modules conventionally use.
_TOKEN_NODE = {
    "session": "session", "ses": "session", "replica": "session",
    "r": "session",
    "pump": "pump", "p": "pump",
    "router": "router",
    "pool": "pool", "batcher": "pool",
    "injector": "injector", "inj": "injector", "faults": "injector",
}
# Module-level locks: (module, name) -> node.  `launch_lock` is one lock
# however it is reached (`with launch_lock:` in _build.py,
# `with _build.launch_lock:` in ops.py).
_MODULE_LOCK_NODE = {("_build", "_lock"): BUILD_NODE,
                     ("_build", "launch_lock"): "launch"}
_LOCK_ATTRS = ("lock", "_lock", "launch_lock")

# RLocks: same-lock reacquisition on one thread is legal, not an edge.
REENTRANT = {"session"}


def _lock_node(expr: ast.AST, cls: str | None, module: str) -> str | None:
    """Map a with-item expression to a lock-node name, or None when the
    expression is not a lock acquisition we track.  A bare name (no
    receiver) is a module-level lock of ``module``."""
    chain = dotted_name(expr)
    if not chain:
        return None
    parts = chain.split(".")
    name = parts[-1]
    if name not in _LOCK_ATTRS:
        return None
    recv = parts[:-1]
    if recv == ["self"]:
        return _CLASS_NODE.get(cls or "", (cls or "module").lower())
    owner = recv[-1] if recv else module
    if (owner, name) in _MODULE_LOCK_NODE:
        return _MODULE_LOCK_NODE[(owner, name)]
    if name == "launch_lock":
        return "launch"
    if not recv:
        return f"{module}.{name}"
    return _TOKEN_NODE.get(owner, owner)


def _recv_node(expr: ast.AST, cls: str | None) -> str | None:
    """Resolve a call receiver (``self.session`` / ``ses`` / ``pool``) to
    a lock-node name."""
    chain = dotted_name(expr)
    if not chain:
        return None
    parts = chain.split(".")
    if parts == ["self"]:
        return _CLASS_NODE.get(cls or "", (cls or "module").lower())
    return _TOKEN_NODE.get(parts[-1])


def _blocking_kind(call: ast.Call) -> str | None:
    """'build' for a kernel-library build or load, 'sync' for a host
    sync, 'block' for the reference's blocking calls, None otherwise."""
    name = dotted_name(call.func)
    if name in BUILD_CALLS or library_build_site(name):
        return "build"
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in HOST_SYNC_ATTRS:
        return "sync"
    if attr not in BLOCKED_ATTRS:
        return None
    if attr == "join" and call.args:
        return None  # ", ".join(parts) — string formatting, not a thread
    return "block"


def _blocking_why(call: ast.Call, kind: str, held: str) -> str:
    name = dotted_name(call.func) or f".{call.func.attr}"
    if kind == "sync":
        return (f"`{name}()` is a host sync inside a `with {held}` body — "
                "it waits for every queued kernel while the lock's other "
                "users queue behind it; fetch outside the lock")
    if kind == "build":
        return (f"`{name}()` builds or loads the kernel library inside a "
                f"`with {held}` body — a first-use nvcc build runs for "
                "seconds; build in warmup, outside serving locks")
    return (f"`{name}()` blocks inside a `with {held}` body — claim under "
            "the lock, pack/execute/wait outside it")


def _walk_no_nested_defs(node: ast.AST):
    """Walk an AST subtree without descending into nested function/class
    definitions — a closure defined under a lock does not run there."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


def _acquired(fn: ast.AST, cls: str | None, module: str) -> set[str]:
    return {ln for stmt in ast.walk(fn) if isinstance(stmt, ast.With)
            for item in stmt.items
            if (ln := _lock_node(item.context_expr, cls, module))
            is not None}


def check(files: list[ParsedFile]) -> list[Finding]:
    files = [pf for pf in files if in_port(pf.rel)]
    findings: list[Finding] = []

    # Pass 1: which locks does each (node, method) or (module, function)
    # acquire directly?
    method_locks: dict[tuple[str, str], set[str]] = {}
    func_locks: dict[tuple[str, str], set[str]] = {}
    for pf in files:
        module = module_name(pf.rel)
        for qual, cls, fn in iter_functions(pf.tree):
            acquired = _acquired(fn, cls, module)
            if not acquired:
                continue
            if cls is None:
                if qual == fn.name:          # module-level function
                    func_locks.setdefault((module, fn.name),
                                          set()).update(acquired)
                continue
            node = _CLASS_NODE.get(cls)
            if node is not None:
                method_locks.setdefault((node, fn.name),
                                        set()).update(acquired)

    def callee_locks(call: ast.Call, cls: str | None, module: str):
        f = call.func
        if isinstance(f, ast.Name):
            return func_locks.get((module, f.id), ())
        if not isinstance(f, ast.Attribute):
            return ()
        recv = _recv_node(f.value, cls)
        if recv is not None:
            return method_locks.get((recv, f.attr), ())
        chain = dotted_name(f.value)
        if chain:
            return func_locks.get((chain.split(".")[-1], f.attr), ())
        return ()

    # Pass 2: blocking calls under locks + acquisition-order edges.
    edges: dict[tuple[str, str], tuple[str, int]] = {}

    def add_edges(held: list[str], new: str, site: tuple[str, int]):
        for h in held:
            if h == new and new in REENTRANT:
                continue
            edges.setdefault((h, new), site)

    def visit_body(stmts, held: list[str], pf: ParsedFile,
                   cls: str | None, module: str) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.With):
                new = [ln for item in stmt.items
                       if (ln := _lock_node(item.context_expr, cls,
                                            module))]
                for ln in new:
                    add_edges(held, ln, (pf.rel, stmt.lineno))
                visit_body(stmt.body, held + new, pf, cls, module)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if held:
                # scan only the expressions attached to THIS statement;
                # nested statement bodies are handled by the recursion
                # below so each call is inspected exactly once
                for child in ast.iter_child_nodes(stmt):
                    if not isinstance(child, ast.expr):
                        continue
                    for sub in [child, *_walk_no_nested_defs(child)]:
                        if not isinstance(sub, ast.Call):
                            continue
                        kind = _blocking_kind(sub)
                        if kind is not None and not (
                                kind == "build"
                                and set(held) == {BUILD_NODE}):
                            findings.append(Finding(
                                "CL001", pf.rel, sub.lineno,
                                _blocking_why(sub, kind, held[-1])))
                        # one level of call resolution: a callee that
                        # itself takes a lock extends the edge graph
                        for ln in callee_locks(sub, cls, module):
                            add_edges(held, ln, (pf.rel, sub.lineno))
            # recurse into compound statements to track nested withs
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    visit_body(sub, held, pf, cls, module)
            for h in getattr(stmt, "handlers", []):
                visit_body(h.body, held, pf, cls, module)

    for pf in files:
        module = module_name(pf.rel)
        for qual, cls, fn in iter_functions(pf.tree):
            visit_body(fn.body, [], pf, cls, module)

    cyc = find_cycle(edges)
    if cyc:
        closing = edges.get((cyc[-2], cyc[-1])) or next(iter(edges.values()))
        findings.append(Finding(
            "CL002", closing[0], closing[1],
            "lock-order cycle " + " -> ".join(cyc)
            + " — two threads taking these locks in opposite order deadlock"))
    return findings


def find_cycle(edges) -> list[str] | None:
    """A cycle of the edge graph as a node path that ends where it began,
    or None.  Self-loops on non-reentrant locks arrive as (A, A) edges and
    form length-1 cycles."""
    adj: dict[str, list[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}
    path: list[str] = []

    def dfs(n: str) -> list[str] | None:
        color[n] = GREY
        path.append(n)
        for m in adj.get(n, ()):
            if color.get(m, WHITE) == GREY:
                return path[path.index(m):] + [m]
            if color.get(m, WHITE) == WHITE:
                cyc = dfs(m)
                if cyc:
                    return cyc
        path.pop()
        color[n] = BLACK
        return None

    for n in list(adj):
        if color.get(n, WHITE) == WHITE:
            cyc = dfs(n)
            if cyc:
                return cyc
    return None
