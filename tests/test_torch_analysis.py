"""Self-tests for the port's cascade-lint (repro_torch.analysis), and its
parity with the JAX package's (repro.analysis).

Every rule is tested in both directions: it MUST flag its seeded
violation in the port's fixture corpus (the reference's package-neutral
fixtures, copied, plus one per torch idiom the port adds), and MUST NOT
flag the live tree (src/repro_torch, the port's tests, chip_smoke.py).
The cross-file rules (CL007 seams, CL011 identity) and CL001 are also
tested against doctored copies of the port's real serving sources. The
reference lint and the port's agree (rule, line) on every package-neutral
reference fixture, and the two runtime witnesses record the same edges
and inversions for the same scripted acquisition sequence.
"""
import ast
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from repro.analysis import core as jcore
from repro.analysis import witness as jwitness
from repro_torch.analysis import accounting, containment, core, \
    determinism, locks, recompile
from repro_torch.analysis.witness import (
    LockOrderInversion,
    LockOrderWitness,
    _WitnessedLock,
    install_witness,
)

REPO = core.REPO_ROOT
FIX = core.FIXTURES_DIR
JOIN_S = 30.0


@pytest.fixture(scope="module")
def live_findings():
    files = core.collect_files(core.default_targets())
    return core.run(files)


def _pf(rel: str, src: str) -> core.ParsedFile:
    return core.ParsedFile(Path(rel), rel, ast.parse(src), src)


def _fixture_rules(name: str) -> set:
    files = core.collect_files([FIX / name])
    assert len(files) == 1
    return {f.rule for f in core.run(files)}


def test_live_tree_clean(live_findings):
    assert not live_findings, "\n".join(str(f) for f in live_findings)


def test_registry_covers_all_rules():
    assert set(core.all_rules()) == {f"CL{i:03d}" for i in range(1, 12)}


# (fixture, the rules it seeds): the reference's package-neutral corpus,
# copied, then one fixture per torch idiom the port's rules add
FIXTURE_RULES = [
    ("bad_lock_block.py", {"CL001"}),
    ("bad_lock_cycle.py", {"CL002"}),
    ("bad_clock.py", {"CL005"}),
    ("bad_rng.py", {"CL006"}),
    ("bad_except.py", {"CL007"}),
    ("bad_future.py", {"CL008"}),
    ("bad_stats.py", {"CL009", "CL010"}),
    ("bad_identity_serve.py", {"CL011"}),
    ("bad_host_sync.py", {"CL001"}),
    ("bad_launch_cycle.py", {"CL002"}),
    ("bad_graph.py", {"CL003"}),
    ("bad_cdll.py", {"CL003"}),
    ("bad_staging.py", {"CL004"}),
    ("bad_torch_rng.py", {"CL006"}),
]


@pytest.mark.parametrize("fixture,rules", FIXTURE_RULES,
                         ids=[f for f, _ in FIXTURE_RULES])
def test_fixture_flags_seeded_violation(fixture, rules, live_findings):
    assert _fixture_rules(fixture) == rules
    # ...and the same rules are silent on the live tree
    assert not rules & {f.rule for f in live_findings}


def test_every_fixture_is_covered():
    assert {f for f, _ in FIXTURE_RULES} == {
        p.name for p in FIX.glob("bad_*.py")}
    assert set().union(*(r for _, r in FIXTURE_RULES)) == set(
        core.all_rules())


def test_default_walk_skips_fixture_corpus():
    files = core.collect_files(core.default_targets())
    assert not any("analysis/fixtures" in f.rel for f in files)
    rels = {f.rel for f in files}
    assert {"chip_smoke.py", "tests/torch_parity.py",
            "tests/test_torch_analysis.py",
            "src/repro_torch/serving/session.py"} <= rels
    assert not any(r.startswith("src/repro/") for r in rels)
    # but explicit paths always get in
    files = core.collect_files([FIX / "bad_clock.py"])
    assert len(files) == 1


# ---- doctored-source direction for the cross-file rules ----------------

def test_cl011_fires_when_identity_deleted():
    rel = "src/repro_torch/launch/serve.py"
    real = (REPO / rel).read_text()
    assert not [f for f in accounting.check([_pf(rel, real)])
                if f.rule == "CL011"]
    doctored = real.replace(
        'st["submitted"] != st["completed"] + st["shed"] + st["errors"]',
        "False")
    assert doctored != real
    assert any(f.rule == "CL011"
               for f in accounting.check([_pf(rel, doctored)]))


@pytest.mark.parametrize("rel", ["src/repro_torch/serving/pump.py",
                                 "src/repro_torch/serving/session.py"])
def test_cl007_fires_when_seam_loses_noqa(rel):
    real = (REPO / rel).read_text()
    assert not [f for f in containment.check([_pf(rel, real)])
                if f.rule == "CL007"]
    doctored = real.replace("# noqa: BLE001", "#", 1)
    assert doctored != real
    found = [f for f in containment.check([_pf(rel, doctored)])
             if f.rule == "CL007"]
    assert found and "noqa" in found[0].why


@pytest.mark.parametrize("call", [
    "self._sleep(0.01)",                # the reference's case
    "torch.cuda.synchronize()",         # host syncs
    "self.params['w'].sum().item()",
    "_build.load_library()",            # a first-use kernel build
])
def test_cl001_fires_on_seeded_block_in_real_session(call):
    rel = "src/repro_torch/serving/session.py"
    real = (REPO / rel).read_text()
    assert not locks.check([_pf(rel, real)])
    doctored = real.replace('self.stats["submitted"] += 1',
                            f'self.stats["submitted"] += 1; {call}', 1)
    assert doctored != real
    assert [f.rule for f in locks.check([_pf(rel, doctored)])] == ["CL001"]


def test_cl001_allows_the_build_under_the_build_lock_only():
    rel = "src/repro_torch/kernels/_build.py"
    real = (REPO / rel).read_text()
    assert "ctypes.CDLL(str(build()))" in real
    assert not locks.check([_pf(rel, real)])
    # the same load under the launch lock is a finding
    doctored = real.replace("with _lock:", "with launch_lock:", 1)
    assert doctored != real
    assert [f.rule for f in locks.check([_pf(rel, doctored)])] == ["CL001"]


# ---- the port's lock nodes ------------------------------------------------

@pytest.mark.parametrize("rel,func,node", [
    ("src/repro_torch/kernels/_build.py", "load_library", "build"),
    ("src/repro_torch/kernels/_build.py", "count_launch", "launch"),
    ("src/repro_torch/kernels/ops.py", "launch_counts", "launch"),
    ("src/repro_torch/kernels/ops.py", "reset_launch_counts", "launch"),
])
def test_module_locks_map_to_their_nodes(rel, func, node):
    tree = ast.parse((REPO / rel).read_text())
    fn = next(f for q, _, f in core.iter_functions(tree) if q == func)
    assert locks._acquired(fn, None, core.module_name(rel)) == {node}


@pytest.mark.parametrize("expr,cls,module,node", [
    ("_lock", None, "_build", "build"),
    ("launch_lock", None, "_build", "launch"),
    ("_build.launch_lock", None, "ops", "launch"),
    ("_build._lock", None, "ops", "build"),
    ("launch_lock", None, "bad_launch_cycle", "launch"),
    ("_lock", None, "other", "other._lock"),     # no receiver: no raise
    ("self.lock", "CascadeSession", "session", "session"),
    ("ses.lock", "SessionPump", "pump", "session"),
    ("self._lock", "ReplicaRouter", "router", "router"),
    ("self.pool", "CascadeSession", "session", None),
])
def test_lock_node(expr, cls, module, node):
    tree = ast.parse(expr, mode="eval")
    assert locks._lock_node(tree.body, cls, module) == node


def test_static_cycle_through_a_called_function():
    # one level of call resolution reaches module-level functions: a
    # launch counted under the session lock (through count_launch) and
    # the session lock taken under the launch lock close a cycle
    build = (REPO / "src/repro_torch/kernels/_build.py").read_text()
    user = ("from repro_torch.kernels import _build\n\n\n"
            "def counted(session, w):\n"
            "    with session.lock:\n"
            "        _build.count_launch(w)\n\n\n"
            "def inverted(session):\n"
            "    with _build.launch_lock:\n"
            "        with session.lock:\n"
            "            return 0\n")
    files = [_pf("src/repro_torch/kernels/_build.py", build),
             _pf("src/repro_torch/serving/user.py", user)]
    found = [f for f in locks.check(files) if f.rule == "CL002"]
    assert found and "session" in found[0].why and "launch" in found[0].why
    assert not locks.check(files[:1])


# ---- CL003 / CL004 / CL006 on inline sources ------------------------------

@pytest.mark.parametrize("rel,src,rules", [
    ("src/repro_torch/serving/x.py",
     "import torch\n\n@torch.compile\ndef f(x):\n    return x\n", ["CL003"]),
    ("src/repro_torch/serving/x.py",
     "import torch\n\n@torch.compile(mode='max-autotune')\n"
     "def f(x):\n    return x\n", ["CL003"]),
    ("src/repro_torch/serving/x.py",
     "import torch\n\ng = torch.cuda.CUDAGraph()\n", ["CL003"]),
    ("src/repro_torch/serving/x.py",
     "import torch\n\ndef f(m):\n    return torch.jit.script(m)\n",
     ["CL003"]),
    ("src/repro_torch/serving/x.py",
     "import subprocess\n\ndef f():\n    subprocess.run(['nvcc'])\n",
     ["CL003"]),
    ("src/repro_torch/serving/x.py",
     "from torch.utils import cpp_extension\n\ndef f():\n"
     "    return cpp_extension.load('k', ['k.cu'])\n", ["CL003"]),
    ("src/repro_torch/kernels/_build.py",
     "import ctypes, subprocess\n\ndef f(p):\n    subprocess.run(['nvcc'])\n"
     "    return ctypes.CDLL(p)\n", []),
    ("src/repro_torch/serving/x.py",
     "import torch\n\ndef f(b):\n    return dict(x=torch.zeros(b), "
     "q=torch.zeros(b), mask=torch.zeros(b), m_q=torch.ones(b))\n",
     ["CL004"]),
    ("src/repro_torch/serving/x.py",
     "from repro_torch.serving.batching import alloc_pinned_batch\n\n"
     "def f():\n    return alloc_pinned_batch(1, 16, 24, 8)\n", ["CL004"]),
    ("src/repro_torch/serving/batching.py",
     "def f(b):\n    return dict(x=b, q=b, mask=b, m_q=b)\n", []),
    ("src/repro_torch/serving/x.py",
     "def f(b):\n    return dict(x=b, q=b, mask=b, m_q=b, y=b)\n", []),
])
def test_recompile_rules_on_inline_sources(rel, src, rules):
    assert [f.rule for f in recompile.check([_pf(rel, src)])] == rules


@pytest.mark.parametrize("line,flagged", [
    ("torch.randn(3)", True),
    ("torch.randint(0, 5, (3,))", True),
    ("torch.randn(3, generator=g)", False),
    ("w.normal_(0.0, 0.02)", True),
    ("w.normal_(0.0, 0.02, generator=g)", False),
    ("torch.nn.init.uniform_(w)", True),
    ("torch.manual_seed(0)", True),
    ("torch.cuda.manual_seed_all(0)", True),
    ("torch.Generator().manual_seed(0)", False),
    ("g.manual_seed(0)", False),
    ("np.random.default_rng(0).normal()", False),
])
def test_torch_rng_rules(line, flagged):
    src = f"import numpy as np\nimport torch\n\n\ndef f(w, g):\n    {line}\n"
    found = determinism.check([_pf("src/repro_torch/core/x.py", src)])
    assert [(f.rule, f.line) for f in found] == (
        [("CL006", 6)] if flagged else [])
    # the rules hold the port only
    assert not determinism.check([_pf("tests/test_torch_x.py", src)])


# ---- parity with the reference lint -------------------------------------

NEUTRAL = ["bad_clock.py", "bad_except.py", "bad_future.py",
           "bad_identity_serve.py", "bad_lock_block.py", "bad_lock_cycle.py",
           "bad_rng.py", "bad_stats.py", "bad_shape.py"]


@pytest.mark.parametrize("name", NEUTRAL)
def test_lint_parity_on_reference_fixture(name, tmp_path):
    ref_path = jcore.FIXTURES_DIR / name
    want = {(f.rule, f.line)
            for f in jcore.run(jcore.collect_files([ref_path]))}
    port_path = tmp_path / "src" / "repro_torch" / "serving" / name
    port_path.parent.mkdir(parents=True)
    port_path.write_text(ref_path.read_text())
    files = core.collect_files([port_path], root=tmp_path)
    assert [f.rel for f in files] == [f"src/repro_torch/serving/{name}"]
    got = {(f.rule, f.line) for f in core.run(files)}
    assert want and got == want


# Each step is one thread's nested acquisitions (outermost first), run to
# completion before the next starts; "r" is an RLock.
WITNESS_SCRIPTS = {
    "inversion": [["a", "b"], ["b", "a"]],
    "three_cycle": [["a", "b"], ["b", "c"], ["c", "a"], ["a", "c"]],
    "consistent": [["a", "b"], ["a", "b", "c"], ["b", "c"]],
    "reentry": [["r", "r", "a"], ["a"], ["r", "a", "r"]],
}


def _run_script(witness_cls, steps):
    w = witness_cls()
    lks = {n: w.wrap(threading.Lock(), n) for n in "abc"}
    lks["r"] = w.wrap(threading.RLock(), "r")

    def run(names):
        taken = []
        try:
            for n in names:
                lks[n].acquire()
                taken.append(lks[n])
        finally:
            for lk in reversed(taken):
                lk.release()

    for names in steps:
        t = threading.Thread(target=run, args=(names,))
        t.start()
        t.join(JOIN_S)
        assert not t.is_alive()
    return sorted(w.edges.values()), list(w.inversions)


@pytest.mark.parametrize("script", sorted(WITNESS_SCRIPTS))
def test_witness_parity_on_scripted_sequence(script):
    steps = WITNESS_SCRIPTS[script]
    j_edges, j_inv = _run_script(jwitness.LockOrderWitness, steps)
    t_edges, t_inv = _run_script(LockOrderWitness, steps)
    assert t_edges == j_edges
    assert t_inv == j_inv
    assert bool(t_inv) == (script in ("inversion", "three_cycle"))


# ---- CLI ----------------------------------------------------------------

def _run_cli(args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_cli_clean_tree_exit_zero_and_report(tmp_path):
    report = tmp_path / "ANALYSIS_torch_report.json"
    proc = _run_cli(["--report", str(report)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(report.read_text())
    assert data["ok"] is True
    assert data["files_scanned"] > 50
    assert len(data["rules"]) == 11


def test_cli_nonzero_on_fixture(tmp_path):
    report = tmp_path / "r.json"
    proc = _run_cli(["--report", str(report),
                     str(FIX / "bad_clock.py")])
    assert proc.returncode == 1
    data = json.loads(report.read_text())
    assert data["ok"] is False
    f = data["findings"][0]
    assert set(f) == {"rule", "file", "line", "why"}
    assert f["rule"] == "CL005" and f["line"] == 6
    assert "src/repro_torch/analysis/fixtures/bad_clock.py:6 [CL005]" \
        in proc.stdout


def test_cli_imports_neither_jax_repro_nor_torch():
    code = (
        "import sys\n"
        "from repro_torch.analysis.__main__ import main\n"
        "rc = main(['--no-report'])\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'torch', 'numpy'))\n"
        "assert rc == 0 and not bad, (rc, bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---- runtime lock-order witness ----------------------------------------

def test_witness_catches_two_thread_inversion():
    w = LockOrderWitness()
    a = w.wrap(threading.Lock(), "a")
    b = w.wrap(threading.Lock(), "b")

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    # run to completion sequentially — no deadlock ever happens, the
    # inversion is caught purely from the recorded order graph
    for fn in (ab, ba):
        t = threading.Thread(target=fn)
        t.start()
        t.join(JOIN_S)
        assert not t.is_alive()
    assert w.inversions
    with pytest.raises(LockOrderInversion):
        w.assert_clean()


def test_witness_consistent_order_is_clean():
    w = LockOrderWitness()
    a = w.wrap(threading.Lock(), "a")
    b = w.wrap(threading.Lock(), "b")
    for _ in range(3):
        with a:
            with b:
                pass
    w.assert_clean()
    assert w.edge_kinds() == {("a", "b")}
    assert w.acquisitions() == {"a": 3, "b": 3}


def test_witness_rlock_reentry_is_not_an_edge():
    w = LockOrderWitness()
    r = w.wrap(threading.RLock(), "session")
    with r:
        with r:
            pass
    assert not w.edges
    w.assert_clean()


def test_witness_distinct_instances_are_distinct_nodes():
    # two replicas' session locks taken in "opposite" order are NOT an
    # inversion — identity is id()-level, not name-level
    w = LockOrderWitness()
    s1 = w.wrap(threading.Lock(), "session@1")
    s2 = w.wrap(threading.Lock(), "session@2")
    with s1:
        with s2:
            pass
    w.assert_clean()
    assert w.edge_kinds() == {("session", "session")}


def test_install_witness_wraps_and_uninstalls():
    from repro_torch.kernels import _build, ops
    from repro_torch.serving.batching import TransferBufferPool
    build_lock, launch_lock = _build._lock, _build.launch_lock
    witness, uninstall = install_witness()
    try:
        pool = TransferBufferPool(4, 3)
        assert isinstance(pool._lock, _WitnessedLock)
        assert isinstance(_build._lock, _WitnessedLock)
        assert isinstance(_build.launch_lock, _WitnessedLock)
        buf = pool.acquire(2, 4)  # exercise the wrapped lock
        pool.release(buf)
        ops.launch_counts()       # ops reads _build.launch_lock at call time
        witness.assert_clean()
        assert witness.acquisitions() == {"pool": 2, "launch": 1,
                                          "build": 0}
    finally:
        uninstall()
    assert not isinstance(TransferBufferPool(4, 3)._lock, _WitnessedLock)
    assert _build._lock is build_lock and _build.launch_lock is launch_lock


def test_installed_witness_sees_a_class_lock_against_a_module_lock():
    # a launch counted under a pool lock, then the pool lock taken under
    # the launch lock: the real install records pool -> launch and the
    # inversion that closes it
    from repro_torch.kernels import _build
    from repro_torch.serving.batching import TransferBufferPool

    class Wrapper:
        launches = 0

    witness, uninstall = install_witness()
    try:
        pool = TransferBufferPool(4, 3)
        with pool._lock:
            _build.count_launch(Wrapper)
        with _build.launch_lock:
            with pool._lock:
                pass
        assert witness.edge_kinds() == {("pool", "launch"),
                                        ("launch", "pool")}
        with pytest.raises(LockOrderInversion):
            witness.assert_clean()
    finally:
        uninstall()
    assert Wrapper.launches == 1


def test_static_graph_catches_the_same_inversion_pattern():
    # the static twin of the runtime scenario above: the bad_lock_cycle
    # fixture encodes the session/router opposite-order pattern and CL002
    # must find the cycle
    files = core.collect_files([FIX / "bad_lock_cycle.py"])
    found = [f for f in locks.check(files) if f.rule == "CL002"]
    assert found and "session" in found[0].why and "router" in found[0].why
