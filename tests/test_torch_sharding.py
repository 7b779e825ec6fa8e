"""The port's layout rules (`launch/sharding.py`) against the reference's
(`src/repro/launch/sharding.py`), exactly: for every architecture, rule
set and mesh, the port's `param_layouts` on its templates equal the specs
of the reference's `param_shardings` on a `jax.sharding.AbstractMesh` of
the same shape (no devices); likewise `batch_layouts` / `batch_shardings`
on every assigned shape and `cache_layouts` / `cache_shardings` under
both policies on the serving caches of the prefill and decode shapes.
Meshes: the reference's production meshes (16, 16) and (2, 16, 16), and
the model-parallel runs' (1, 2) and (1, 4). Nothing is spawned.
"""

import jax
import pytest
from jax.sharding import AbstractMesh

from repro import configs as JCFG
from repro.configs import shapes as JSH
from repro.launch import mesh as JMESH
from repro.launch import sharding as JSD
from repro.models import base as JMB
from repro_torch import configs as TCFG
from repro_torch.configs import shapes as TSH
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TSD
from repro_torch.models import base as TMB
from repro_torch.models import parallel as TPAR
from repro_torch.models import zoo as TZ
from repro.models import zoo as JZ

ARCHS = TCFG.all_archs()
MODES = ("tp", "fsdp", "zero3")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


def _meshes(key):
    sizes, names = MESHES[key]
    return AbstractMesh(sizes, names), TMESH.MeshShape(names, sizes)


def _spec(sharding) -> tuple:
    return tuple(sharding.spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_layouts_match_the_reference(arch, mode, mesh):
    jm, tm = _meshes(mesh)
    want = JSD.param_shardings(JZ.templates(JCFG.get(arch)), jm, mode)
    got = TSD.param_layouts(TZ.templates(TCFG.get(arch)), tm, mode)
    want_leaves = jax.tree_util.tree_leaves(
        want, is_leaf=lambda s: hasattr(s, "spec"))
    got_leaves = list(TMB.tree_leaves(got))
    assert len(got_leaves) == len(want_leaves)
    assert [_spec(s) for s in want_leaves] == got_leaves
    assert TSD.rules_for(tm, mode) == JSD.rules_for(jm, mode)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_layouts_match_the_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    for shape in JSH.SHAPES:
        want = JSD.batch_shardings(JSH.batch_specs(JCFG.get(arch), shape), jm)
        got = TSD.batch_layouts(TSH.batch_specs(TCFG.get(arch), shape), tm)
        assert got == {k: _spec(v) for k, v in want.items()}, shape


@pytest.mark.parametrize("policy", ["heads", "seq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layouts_match_the_reference(arch, policy):
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        for shape in SERVE_SHAPES:
            want = JSD.cache_shardings(
                JSH.cache_specs(JCFG.get(arch), shape), jm, policy)
            got = TSD.cache_layouts(
                TSH.cache_specs(TCFG.get(arch), shape), tm, policy)
            assert got == {k: _spec(v) for k, v in want.items()}, (mesh,
                                                                   shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_specs_match_the_reference(arch):
    want = JMB.logical_specs(JZ.templates(JCFG.get(arch)))
    got = TMB.logical_specs(TZ.templates(TCFG.get(arch)))
    assert list(TMB.tree_leaves(got)) == jax.tree_util.tree_leaves(
        want, is_leaf=lambda a: isinstance(a, tuple))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_and_its_axes(multi_pod):
    key = "2x16x16" if multi_pod else "16x16"
    jm, _ = _meshes(key)
    tm = TMESH.production_mesh(multi_pod=multi_pod)
    assert tm.axis_names == jm.axis_names and tm.shape == dict(jm.shape)
    assert tm.size == (512 if multi_pod else 256)
    assert TMESH.data_axes(tm) == JMESH.data_axes(jm)
    assert TMESH.model_axis(tm) == JMESH.model_axis(jm) == "model"
    assert TSD.replicated(tm) == tuple(JSD.replicated(jm).spec) == ()


def test_model_mesh_ranks_and_local_parts():
    """The model-parallel mesh puts rank r at model coordinate r; a dim
    cut over ("data", "model") on the production mesh takes the
    row-major block of the two coordinates."""
    mm = TMESH.model_mesh(4)
    assert mm.shape == {"data": 1, "model": 4}
    assert [TPAR.rank_coords(mm, r) for r in range(4)] == [
        {"data": 0, "model": r} for r in range(4)]
    pm = TMESH.production_mesh()
    assert TPAR.rank_coords(pm, 37) == {"data": 2, "model": 5}
    got = TPAR.local_slices((512, 32), (("data", "model"), None), pm, 37)
    assert got == [(37 * 2, 2), (0, 32)]
    with pytest.raises(ValueError, match="cannot be cut"):
        TPAR.local_slices((6, 4), ("model", None), mm, 0)
