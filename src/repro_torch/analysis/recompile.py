"""CL003/CL004 — compile-site hygiene: the zero-new-work-after-warmup
guarantee.

The serving path promises that everything the live phase needs existed
before the first request: warmup (or a warm restart) runs every shape
once, and on a card that first run builds and loads the kernel library.
Two code patterns silently break that promise:

CL003 (compile-site): building or loading the kernel library
(``ctypes.CDLL``, an nvcc ``subprocess``, ``torch.utils.cpp_extension``)
anywhere but ``kernels/_build.py`` is a second, unkeyed build path the
warmup does not run.  Graph capture and compilation (``torch.cuda.graph``
/ ``CUDAGraph`` / ``make_graphed_callables``, ``torch.compile``,
``torch.jit.script`` / ``trace``) record or compile per call site and
per shape; they are allowed only in the blessed capture modules, which
capture once, at warmup.  No module is blessed yet, so every use is a
finding until one is named here.

CL004 (adhoc-batch-shape): the staging-batch layout is the exact dict
``{"x", "q", "mask", "m_q"}`` and every live instance must come from
``alloc_batch`` / ``alloc_pinned_batch`` (the pool) and the warmed pow2
ladder.  A hand-rolled literal or ``dict(x=, q=, mask=, m_q=)`` with
exactly that key set, or an ``alloc_batch`` / ``alloc_pinned_batch`` /
``PinnedBatch`` call, outside the bucket/warmup code is a shape the
warmup never ran.  The trainer's batches are supersets of this key set
and do not match.

Scope: ``src/repro_torch/`` only.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import PORT, Finding, ParsedFile, \
    dotted_name, in_port, iter_functions, walk_own_body

RULES = {
    "CL003": "kernel-library build/load outside kernels/_build.py, or "
             "graph capture/compile outside blessed modules",
    "CL004": "ad-hoc staging-batch construction outside bucket/warmup code",
}

# The one module that builds and loads the kernel library.
BUILD_MODULE = PORT + "kernels/_build.py"
# Modules allowed to capture graphs or compile (item 16 names them).
BLESSED_CAPTURE_MODULES: tuple[str, ...] = ()

_BUILD_CALLS = {"ctypes.CDLL", "ctypes.cdll.LoadLibrary",
                "cpp_extension.load", "cpp_extension.load_inline"}
_CAPTURE_CALLS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                  "torch.cuda.graph", "torch.cuda.graphs.graph"}
_CAPTURE_LAST = {"CUDAGraph", "make_graphed_callables"}

# The staging layout (serving/batching.py alloc_batch).  Exact match only.
STAGING_KEYS = frozenset({"x", "q", "mask", "m_q"})
_STAGING_CALLS = {"alloc_batch", "alloc_pinned_batch", "PinnedBatch"}

# Where the layout may legitimately be built.
BLESSED_SHAPE_FILES = (PORT + "serving/batching.py",)
BLESSED_SHAPE_FUNCTIONS = {
    (PORT + "serving/session.py", "warm_restart"),
    (PORT + "serving/session.py", "warmup"),
}


def library_build_site(name: str) -> bool:
    """A call that builds or loads a kernel library (by dotted name)."""
    return (name in _BUILD_CALLS or name.startswith("subprocess.")
            or ".".join(name.split(".")[-2:]) in _BUILD_CALLS)


def _capture_site(name: str) -> bool:
    return name in _CAPTURE_CALLS or name.split(".")[-1] in _CAPTURE_LAST


def _staging_dict(node: ast.AST) -> bool:
    if isinstance(node, ast.Dict):
        keys = {k.value for k in node.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        return len(node.keys) == len(STAGING_KEYS) and keys == STAGING_KEYS
    if isinstance(node, ast.Call) and dotted_name(node.func) == "dict" \
            and not node.args:
        keys = {k.arg for k in node.keywords}
        return len(node.keywords) == len(STAGING_KEYS) \
            and keys == STAGING_KEYS
    return False


def _sites(tree: ast.Module):
    """(qualname, node, called name) for every call and every decorator
    of the module, each once: the module body's and each function's own
    calls in that scope, a decorator in the scope of what it decorates."""
    for qual, scope in [("<module>", tree),
                        *((q, fn) for q, _, fn in iter_functions(tree))]:
        for node in walk_own_body(scope):
            if isinstance(node, ast.Call):
                yield qual, node, dotted_name(node.func)
            elif isinstance(node, ast.Dict):
                yield qual, node, ""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            for dec in node.decorator_list:
                yield node.name, dec, dotted_name(
                    dec.func if isinstance(dec, ast.Call) else dec)


def check(files: list[ParsedFile]) -> list[Finding]:
    files = [pf for pf in files if in_port(pf.rel)]
    findings: list[Finding] = []
    for pf in files:
        may_build = pf.rel == BUILD_MODULE
        may_capture = any(pf.rel.startswith(p)
                          for p in BLESSED_CAPTURE_MODULES)
        for qual, node, name in _sites(pf.tree):
            if name and library_build_site(name) and not may_build:
                findings.append(Finding(
                    "CL003", pf.rel, node.lineno,
                    f"`{name}` in `{qual}` builds or loads a kernel "
                    "library outside kernels/_build.py — a second build "
                    "path that warmup never runs"))
            if name and _capture_site(name) and not may_capture:
                findings.append(Finding(
                    "CL003", pf.rel, node.lineno,
                    f"`{name}` in `{qual}` captures or compiles outside "
                    "the blessed capture modules — capture once, at "
                    "warmup, in a module named in BLESSED_CAPTURE_MODULES"))
            if pf.rel in BLESSED_SHAPE_FILES or (
                    pf.rel, qual.split(".")[-1]) in BLESSED_SHAPE_FUNCTIONS:
                continue
            if _staging_dict(node):
                findings.append(Finding(
                    "CL004", pf.rel, node.lineno,
                    f"hand-rolled staging batch in `{qual}` — shapes must "
                    "come from alloc_batch / the pool and the warmed pow2 "
                    "ladder, or warmup never ran them"))
            elif name and name.split(".")[-1] in _STAGING_CALLS:
                findings.append(Finding(
                    "CL004", pf.rel, node.lineno,
                    f"`{name}` called from `{qual}` — only the "
                    "bucket/warmup code may mint batch buffers (pool reuse "
                    "+ ladder shapes)"))
    return findings
