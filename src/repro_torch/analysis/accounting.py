"""CL009/CL010/CL011 — accounting lint: the lifecycle-counter contract.

``launch.serve`` hard-fails unless the fleet-wide identity
``submitted = completed + shed + errors`` closes at drain, and the
per-session snapshot identity (… + pending + inflight) is what a live
reporter asserts.  That only works while three structural facts hold:

CL009 (stats-undeclared): every counter a class mutates is declared in
its ``self.stats = {...}`` literal — an undeclared key is a KeyError at
the first increment on one path and a silently missing metric on others.
Cross-class mutations (the pump touching ``self.session.stats``) are
checked against the owning class's literal.

CL010 (stats-unexported): ``stats_export()`` must cover every declared
counter.  The blessed pattern is a single ``dict(self.stats)`` snapshot
under the lock; a cherry-picking export silently drops counters from the
metrics surface.

CL011 (identity-key-missing): the identity's keys must be declared on
``CascadeSession`` and the comparison itself must exist in
``launch/serve.py`` — deleting the gate is as much a regression as
breaking it.

The port's ``CascadeSession``, ``SessionPump`` and ``ReplicaRouter`` keep
the reference's counters, literals and exports; scope:
``src/repro_torch/`` only.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Finding, ParsedFile, dotted_name, \
    in_port, iter_functions, walk_own_body

RULES = {
    "CL009": "stats counter mutated but not declared in the stats literal",
    "CL010": "declared stats counter not covered by stats_export()",
    "CL011": "lifecycle-identity key or identity expression missing",
}

IDENTITY_KEYS = frozenset({"submitted", "completed", "shed", "errors"})

# Receiver-token -> owning class, for cross-class stats mutations.
_TOKEN_CLASS = {
    "session": "CascadeSession", "ses": "CascadeSession",
    "replica": "CascadeSession", "r": "CascadeSession",
    "pump": "SessionPump", "p": "SessionPump",
    "router": "ReplicaRouter",
}


def _stats_target(node: ast.AST, cls: str | None):
    """If ``node`` is ``<recv>.stats["key"]``, return (owner_class, key);
    otherwise None.  Unknown receivers return owner_class None."""
    if not isinstance(node, ast.Subscript):
        return None
    if not isinstance(node.value, ast.Attribute) \
            or node.value.attr != "stats":
        return None
    sl = node.slice
    if not (isinstance(sl, ast.Constant) and isinstance(sl.value, str)):
        return None
    recv = dotted_name(node.value.value)
    if recv == "self":
        owner = cls
    else:
        owner = _TOKEN_CLASS.get(recv.split(".")[-1])
    return owner, sl.value


def check(files: list[ParsedFile]) -> list[Finding]:
    files = [pf for pf in files if in_port(pf.rel)]
    findings: list[Finding] = []

    # Pass 1: declared stats literals and export style, per class.
    declared: dict[str, set[str]] = {}
    exports: dict[str, tuple[ParsedFile, ast.FunctionDef]] = {}
    class_site: dict[str, tuple[str, int]] = {}
    for pf in files:
        for qual, cls, fn in iter_functions(pf.tree):
            if cls is None:
                continue
            for node in walk_own_body(fn):
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Attribute) \
                        and node.targets[0].attr == "stats" \
                        and dotted_name(node.targets[0].value) == "self" \
                        and isinstance(node.value, ast.Dict):
                    keys = {k.value for k in node.value.keys
                            if isinstance(k, ast.Constant)}
                    declared.setdefault(cls, set()).update(keys)
                    class_site[cls] = (pf.rel, node.lineno)
            if fn.name == "stats_export" and qual == f"{cls}.stats_export":
                exports[cls] = (pf, fn)

    # Pass 2: every mutation checks against the owner's literal.
    for pf in files:
        for qual, cls, fn in iter_functions(pf.tree):
            for node in walk_own_body(fn):
                targets = []
                if isinstance(node, ast.AugAssign):
                    targets = [node.target]
                elif isinstance(node, ast.Assign):
                    targets = node.targets
                for t in targets:
                    hit = _stats_target(t, cls)
                    if hit is None:
                        continue
                    owner, key = hit
                    if owner is None or owner not in declared:
                        continue
                    if key not in declared[owner]:
                        findings.append(Finding(
                            "CL009", pf.rel, node.lineno,
                            f"`{qual}` mutates stats[{key!r}] which "
                            f"{owner}'s stats literal never declares — "
                            "the counter is invisible to exports and "
                            "KeyErrors on += paths"))

    # Pass 3: export coverage.
    for cls, keys in declared.items():
        if cls not in exports:
            continue
        pf, fn = exports[cls]
        full_snapshot = any(
            isinstance(n, ast.Call) and dotted_name(n.func) == "dict"
            and n.args and dotted_name(n.args[0]).endswith("stats")
            for n in walk_own_body(fn))
        if full_snapshot:
            continue
        exported = {n.slice.value for n in walk_own_body(fn)
                    if isinstance(n, ast.Subscript)
                    and isinstance(n.slice, ast.Constant)}
        for key in sorted(keys - exported):
            findings.append(Finding(
                "CL010", pf.rel, fn.lineno,
                f"{cls}.stats_export never exports declared counter "
                f"{key!r} — snapshot with dict(self.stats) so the "
                "metrics surface cannot drift"))

    # Pass 4: the identity itself.
    if "CascadeSession" in declared:
        missing = IDENTITY_KEYS - declared["CascadeSession"]
        if missing:
            rel, line = class_site["CascadeSession"]
            findings.append(Finding(
                "CL011", rel, line,
                f"CascadeSession stats literal lacks identity key(s) "
                f"{sorted(missing)} — the lifecycle identity cannot "
                "close without them"))
    for pf in files:
        if not pf.rel.endswith("serve.py"):
            continue
        has_identity = any(
            isinstance(n, ast.Compare) and IDENTITY_KEYS <= {
                c.value for c in ast.walk(n)
                if isinstance(c, ast.Constant) and isinstance(c.value, str)}
            for n in ast.walk(pf.tree))
        if not has_identity:
            findings.append(Finding(
                "CL011", pf.rel, 1,
                "launch/serve.py no longer asserts the accounting "
                "identity submitted == completed + shed + errors — the "
                "zero-dropped guarantee is unenforced"))
    return findings
