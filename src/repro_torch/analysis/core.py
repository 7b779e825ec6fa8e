"""cascade-lint core for the port: file collection, scope, checker
registry, report writing.

Deliberately dependency-free (stdlib ``ast`` only, no ``torch``) so the
CLI starts in milliseconds: the gate must be cheap enough to run before
anything else, on a machine with or without a card.
"""
from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]

# The seeded-violation fixtures live inside the package so the self-tests
# can point the runner at them by path; the default walk must skip them or
# the gate would fail on its own test corpus.
FIXTURES_DIR = Path(__file__).resolve().parent / "fixtures"

# Scopes, as repo-relative posix prefixes. The trailing slash matters:
# "src/repro_torch" alone would also match a sibling package.
PORT = "src/repro_torch/"
ANALYSIS = PORT + "analysis/"
FIXTURES = ANALYSIS + "fixtures/"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation: file:line, rule id, and a one-line why."""

    rule: str
    file: str
    line: int
    why: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line} [{self.rule}] {self.why}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ParsedFile:
    """A source file parsed once and shared by every checker."""

    path: Path
    rel: str  # posix path relative to the root (or absolute if outside)
    tree: ast.Module
    source: str

    @property
    def lines(self) -> list[str]:
        return self.source.splitlines()


def in_port(rel: str) -> bool:
    """The port's serving/kernel/training code, or the fixture corpus;
    not the analysis package itself (its rule tables name the very calls
    the rules forbid)."""
    return rel.startswith(FIXTURES) or (
        rel.startswith(PORT) and not rel.startswith(ANALYSIS))


def module_name(rel: str) -> str:
    """A file's module stem (``src/repro_torch/kernels/_build.py`` ->
    ``_build``): how module-level locks and functions are named."""
    return Path(rel).stem


def _rel(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.resolve().as_posix()


def default_targets() -> list[Path]:
    """The port's package, its tests and the chip smoke script."""
    tests = REPO_ROOT / "tests"
    return [REPO_ROOT / "src" / "repro_torch",
            *sorted(tests.glob("test_torch_*.py")),
            tests / "torch_parity.py",
            REPO_ROOT / "chip_smoke.py"]


def collect_files(paths: list[Path], *, include_fixtures: bool = False,
                  root: Path | None = None) -> list[ParsedFile]:
    """Parse every ``*.py`` under ``paths``.  Directory walks skip the
    fixture corpus unless asked; explicitly-named files are always taken
    (that is how the self-tests aim the runner at one bad fixture).
    ``root`` is what ``rel`` is relative to (the repository by default):
    a test lints a file at ``<tmp>/src/repro_torch/serving/x.py`` with
    ``root=<tmp>`` as if it were in the repository."""
    root = REPO_ROOT if root is None else Path(root)
    named = {Path(x).resolve() for x in paths}
    out: list[ParsedFile] = []
    seen: set[Path] = set()
    for p in paths:
        p = Path(p)
        candidates = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in candidates:
            f = f.resolve()
            if f in seen:
                continue
            rel = _rel(f, root)
            if (not include_fixtures and rel.startswith(FIXTURES)
                    and f not in named):
                continue
            seen.add(f)
            src = f.read_text()
            out.append(ParsedFile(path=f, rel=rel,
                                  tree=ast.parse(src, filename=str(f)),
                                  source=src))
    return out


def iter_functions(tree: ast.Module):
    """Yield ``(qualname, class_name, node)`` for every function in the
    module, depth-first.  ``qualname`` is dotted (``Cls.method`` or
    ``outer.inner``); ``class_name`` is the nearest enclosing class or
    None for module-level functions."""

    def walk(node, prefix: str, cls: str | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, cls, child
                yield from walk(child, q + ".", cls)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.", child.name)

    yield from walk(tree, "", None)


def walk_own_body(fn: ast.AST):
    """Walk a function's (or a module's) own body, excluding decorators
    and the interiors of nested function/class definitions (those run in
    other scopes)."""
    stack: list[ast.AST] = list(getattr(fn, "body", []))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


def dotted_name(node: ast.AST) -> str:
    """Render ``a.b.c`` attribute chains; '' for anything fancier."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def all_checkers() -> list:
    """The registry.  Imported lazily so a syntax error in one checker
    module surfaces as an ImportError here, not a silent empty gate."""
    from repro_torch.analysis import accounting, containment, \
        determinism, locks, recompile
    return [locks, recompile, determinism, containment, accounting]


def all_rules() -> dict[str, str]:
    rules: dict[str, str] = {}
    for mod in all_checkers():
        rules.update(mod.RULES)
    return rules


def run(files: list[ParsedFile]) -> list[Finding]:
    findings: list[Finding] = []
    for mod in all_checkers():
        findings.extend(mod.check(files))
    return sorted(findings, key=lambda f: (f.file, f.line, f.rule))


def write_report(findings: list[Finding], files: list[ParsedFile],
                 path: Path) -> dict:
    report = {
        "tool": "cascade-lint (repro_torch)",
        "files_scanned": len(files),
        "rules": all_rules(),
        "findings": [f.as_dict() for f in findings],
        "ok": not findings,
    }
    path.write_text(json.dumps(report, indent=1))
    return report
