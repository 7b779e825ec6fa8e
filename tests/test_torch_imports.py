"""The port stands alone: nothing under src/repro_torch, and not
chip_smoke.py, imports jax or the JAX package `repro` — checked on the
source text and in a fresh interpreter that imports every module — and
chip_smoke.py refuses to run without a CUDA card or outside the repo."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SMOKE = REPO / "chip_smoke.py"
# `repro_torch` starts with `repro`: match the JAX package as a whole word.
FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)",
                       re.MULTILINE)


def _port_modules() -> list[str]:
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_has_modules():
    mods = _port_modules()
    for want in ("repro_torch.kernels.ops", "repro_torch.core.pipeline",
                 "repro_torch.serving.session", "repro_torch.launch.serve",
                 "repro_torch.kernels.cascade_loss.kernel",
                 "repro_torch.kernels.cascade_loss.ref",
                 "repro_torch.core.losses", "repro_torch.core.trainer",
                 "repro_torch.core.baselines", "repro_torch.core.metrics",
                 "repro_torch.optim.sgd", "repro_torch.launch.train",
                 "repro_torch.models.base", "repro_torch.models.layers",
                 "repro_torch.models.zoo", "repro_torch.configs.gemma3_27b",
                 "repro_torch.configs.qwen3_8b", "repro_torch.configs.yi_34b",
                 "repro_torch.configs.starcoder2_3b",
                 "repro_torch.configs.pixtral_12b",
                 "repro_torch.kernels.swa_decode.kernel",
                 "repro_torch.kernels.swa_decode.ref",
                 "repro_torch.serving.engine",
                 "repro_torch.serving.cascade_server",
                 "repro_torch.serving.pump", "repro_torch.serving.router",
                 "repro_torch.launch.mesh"):
        assert want in mods


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [SMOKE, REPO / "kernel_ab.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import_in_source(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path.name} imports {hits}"


def test_forbidden_pattern_matches_whole_word_only():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    from repro.core import cascade")
    assert FORBIDDEN.search("import repro\n")
    assert not FORBIDDEN.search("from repro_torch.core import cascade")
    assert not FORBIDDEN.search("import jaxlib_like_name_elsewhere")


def test_importing_every_module_loads_neither_jax_nor_repro():
    mods = _port_modules()
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO / 'src')!r})\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_importing_the_kernels_builds_nothing():
    from repro_torch.kernels import _build
    assert _build._lib is None
    assert not _build.build_info


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_without_a_card_fails_without_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "cuda" in out.stderr.lower()
