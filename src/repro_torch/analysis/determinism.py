"""CL005/CL006 — determinism lint: monotonic clocks, seeded randomness.

Reproducible offline evaluation (the paper's offline/online comparison
protocol) requires that a replayed trace produce byte-identical decisions,
and the port's tests hold it bit for bit to itself across runs.  Two leak
paths:

CL005 (wall-clock): ``time.time()`` / ``datetime.now()`` readings differ
across runs and hosts.  Elapsed-time measurement uses
``time.perf_counter``; scheduling inside the serving stack flows through
the pump seam's monotonic clock so tests can replay it.

CL006 (unseeded-rng): ``np.random.default_rng()`` with no seed, the
legacy ``np.random.*`` global generators, and module-level ``random.*``
draw from ambient process state.  So do torch's global generators: a
``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` / ``normal`` /
``bernoulli`` / ``multinomial`` draw, or an in-place ``.uniform_`` /
``.normal_`` / ``.random_`` / ``.bernoulli_`` / ``.exponential_``, must
pass an explicit ``generator=``; and seeding the globals
(``torch.manual_seed``, ``torch.seed``, ``torch.cuda.manual_seed[_all]``)
is not allowed at all — it reseeds every other caller in the process.
Randomness enters through seeded constructors only.

Scope: ``src/repro_torch/`` only — tests may freely read wall clocks.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Finding, ParsedFile, dotted_name, \
    in_port

RULES = {
    "CL005": "wall-clock read (time.time/datetime.now) in src/repro_torch",
    "CL006": "unseeded RNG (default_rng(), random.*, np.random globals, "
             "torch draws without generator=, global torch seeding)",
}

_WALL_CLOCK = {"time.time", "datetime.now", "datetime.datetime.now",
               "datetime.utcnow", "datetime.datetime.utcnow"}

# np.random attributes that are NOT the seeded-generator API
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "BitGenerator"}

# torch draws that take a generator=, and in-place draws on a tensor
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial"}
_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_",
                  "exponential_"}
# seeding torch's global generators
_TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.seed",
                      "torch.random.manual_seed", "torch.random.seed",
                      "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                      "torch.cuda.seed", "torch.cuda.seed_all"}


def _has_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" for k in call.keywords)


def _torch_rng(call: ast.Call, name: str) -> str | None:
    """Why a torch RNG call draws from global state, or None."""
    if name in _TORCH_GLOBAL_SEED:
        return (f"`{name}()` reseeds torch's global generator for every "
                "caller in the process — pass a seeded torch.Generator")
    parts = name.split(".")
    if len(parts) == 2 and parts[0] == "torch" and parts[1] in _TORCH_DRAWS \
            and not _has_generator(call):
        return (f"`{name}()` without generator= draws from torch's global "
                "generator — pass a seeded torch.Generator")
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in _INPLACE_DRAWS \
            and not _has_generator(call):
        return (f"in-place `.{call.func.attr}()` without generator= draws "
                "from torch's global generator — pass a seeded "
                "torch.Generator")
    return None


def check(files: list[ParsedFile]) -> list[Finding]:
    files = [pf for pf in files if in_port(pf.rel)]
    findings: list[Finding] = []
    for pf in files:
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            why = _torch_rng(node, name)
            if why:
                findings.append(Finding("CL006", pf.rel, node.lineno, why))
            if not name:
                continue
            if name in _WALL_CLOCK:
                findings.append(Finding(
                    "CL005", pf.rel, node.lineno,
                    f"`{name}()` reads the wall clock — use "
                    "time.perf_counter for elapsed time or the pump "
                    "seam's monotonic clock for scheduling"))
            parts = name.split(".")
            if name == "np.random.default_rng" \
                    or name == "numpy.random.default_rng":
                if not node.args and not node.keywords:
                    findings.append(Finding(
                        "CL006", pf.rel, node.lineno,
                        "`default_rng()` without a seed draws from OS "
                        "entropy — thread the config seed through"))
            elif parts[:2] in (["np", "random"], ["numpy", "random"]) \
                    and len(parts) == 3 and parts[2] not in _NP_RANDOM_OK:
                findings.append(Finding(
                    "CL006", pf.rel, node.lineno,
                    f"legacy global `{name}` shares hidden process state "
                    "— use a seeded np.random.default_rng(seed)"))
            elif len(parts) == 2 and parts[0] == "random":
                findings.append(Finding(
                    "CL006", pf.rel, node.lineno,
                    f"stdlib `{name}` draws from the global RNG — use a "
                    "seeded np.random.default_rng(seed)"))
    return findings
