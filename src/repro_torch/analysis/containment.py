"""CL007/CL008 — containment lint: fault seams and future lifecycles.

The fault-tolerance story concentrates broad exception handling into
exactly two seams — the session's retry wrapper and the pump's service
cycle — both of which convert the exception into a terminal request
state (resolve/fail/shed) under a ``finally``.  A broad handler anywhere
else swallows programming errors (and, on a card, a failed kernel launch
or build).

CL007 (broad-except): every ``except Exception`` / bare ``except`` must
carry ``# noqa: BLE001`` on its line AND sit in the allow-listed seam
set below.  Everything else narrows to the concrete classes it expects.

CL008 (future-no-resolution): ``launch.serve`` hard-fails when any
submitted future never resolves; statically, every function that
constructs a ``RankFuture`` must put it on a resolution path — reference
``_pending`` (queued for the flush/resolve machinery), ``_resolve`` /
``_fail``, or the chunk seam (``resolve_chunk`` / ``fail_chunk``).

Scope: CL007 covers ``src/repro_torch/``, ``tests`` and ``chip_smoke.py``
(test harnesses narrow too); CL008 covers ``src/repro_torch/``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import PORT, Finding, ParsedFile, \
    dotted_name, in_port, iter_functions, walk_own_body

RULES = {
    "CL007": "broad `except Exception` outside an allow-listed seam",
    "CL008": "RankFuture constructed with no resolution path",
}

# The containment seams: (repo-relative file, function qualname).  To
# allow-list a new seam it must (a) be added here with a review of its
# resolve/finally structure and (b) carry `# noqa: BLE001` on the except
# line itself.
ALLOWED_SEAMS = {
    (PORT + "serving/session.py", "CascadeSession._execute_with_retry"),
    (PORT + "serving/pump.py", "SessionPump._service_cycle"),
}

_RESOLUTION_MARKERS = {"_pending", "_resolve", "_fail", "resolve_chunk",
                       "fail_chunk", "shed"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    t = handler.type
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    return any(dotted_name(e) in ("Exception", "BaseException")
               for e in elts)


def check(files: list[ParsedFile]) -> list[Finding]:
    findings: list[Finding] = []
    for pf in files:
        port = in_port(pf.rel)
        if not (port or pf.rel.startswith("tests/")
                or pf.rel == "chip_smoke.py"):
            continue
        lines = pf.lines
        for qual, cls, fn in iter_functions(pf.tree):
            # CL007 — broad handlers
            for node in walk_own_body(fn):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                if not _is_broad(node):
                    continue
                line_txt = lines[node.lineno - 1] \
                    if node.lineno - 1 < len(lines) else ""
                has_noqa = "# noqa: BLE001" in line_txt
                seam = (pf.rel, qual) in ALLOWED_SEAMS
                if not (has_noqa and seam):
                    why = ("broad except outside the allow-listed "
                           "containment seams — narrow to the concrete "
                           "classes, or register the seam in "
                           "repro_torch.analysis.containment.ALLOWED_SEAMS "
                           "and tag the line `# noqa: BLE001`")
                    if seam and not has_noqa:
                        why = ("allow-listed seam is missing its "
                               "`# noqa: BLE001` tag")
                    findings.append(
                        Finding("CL007", pf.rel, node.lineno, why))
            # CL008 — future lifecycle (the port only; tests build bare
            # futures to probe timeout/shed behavior deliberately)
            if not port:
                continue
            makes_future = False
            resolved = False
            for node in walk_own_body(fn):
                if isinstance(node, ast.Call):
                    name = dotted_name(node.func)
                    if name and name.split(".")[-1] == "RankFuture":
                        makes_future = True
                if isinstance(node, (ast.Attribute, ast.Name)):
                    token = getattr(node, "attr", None) \
                        or getattr(node, "id", None)
                    if token in _RESOLUTION_MARKERS:
                        resolved = True
            if makes_future and not resolved:
                findings.append(Finding(
                    "CL008", pf.rel, fn.lineno,
                    f"`{qual}` constructs a RankFuture but never queues "
                    "or resolves it — every future must reach "
                    "_pending/_resolve/fail/shed or launch.serve's "
                    "zero-dropped check fails"))
    return findings
