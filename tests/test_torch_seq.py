"""The port's sequence-sharded serving (cfg.attn_shard "seqkv" / "shmap":
the KV sequence over the ranks, `models/layers.py`) on two gloo ranks on
the CPU, against the reference on the same numpy inputs:

* K8's partials mode: `swa_decode_partial_ref` over the blocks of any cut
  of the cache, combined, equals the reference's `swa_decode_ref` and its
  interpreted Pallas `swa_decode` (1e-6 relative and absolute, float32:
  the reference's ref and kernel differ by up to 3.6e-7 on these inputs);
* `blockwise_attention(k_offset=, return_stats=True)` equals the
  reference's (1e-5);
* `shmap_attention` on 2 ranks equals the reference's run by
  `jax.shard_map` on a (data 1, model 2) mesh of two host devices in a
  subprocess (`XLA_FLAGS=--xla_force_host_platform_device_count=2`,
  `with mesh:` + `jax.jit`, as tests/test_torch_tp.py runs
  `moe_ffn_shmap`): within 1e-5 relative, but for at most 0.1% of the
  elements one bfloat16 unit apart (the bf16 wire: a partial within a
  float32 rounding of a bfloat16 boundary rounds apart in the two
  packages); the wire's output is bf16(bf16(a0) + bf16(a1)) / (l0 + l1)
  of the ranks' scaled states exactly; the float32 wire equals the
  reference's dot attention within 1e-5;
* the engine (forward, prefill past gemma3-smoke's window of 32 so its
  rings wrap, then 8 decode steps fed the reference's greedy tokens) with
  the "seq" cache, at tests/test_torch_tp.py's bars: logits rtol 1e-5 /
  atol 2e-4, greedy tokens exact where the reference's top-2 margin
  exceeds 4e-4, every
  cache leaf 1e-5 against the reference's cache cut by
  `cache_layouts(policy="seq")`, every rank holding the same logits bits,
  the collectives of each pass by kind. "seqkv" is held to the
  reference's unsharded engine at those bars (its variant is a GSPMD
  sharding of the same float32 function). "shmap" is held to the
  reference's engine run under attn_shard="shmap" on the two-device mesh
  in the subprocess, because that variant's bfloat16 wires (the attention
  combine over fresh keys, the experts' sum) are part of its function:
  they move the smoke logits by up to 3.4e-3 from the unsharded engine's.
  Against the reference's own shmap run the two packages' float32
  partials still round to bfloat16 apart where one lies within a float32
  rounding of a bfloat16 boundary (about 1% of the forward's attention
  outputs here), and those one-unit differences reach the logits (up to
  9.7e-4 of logits up to 1.35) and the next layers' cache (7.1e-5), past
  those float32 bars. So "shmap"'s logits and cache are held to one
  bfloat16 unit of the largest value (2^-7 max |want|, ~1e-2 for these
  logits), greedy tokens exact where the top-2 margin exceeds twice that,
  and its combine itself exactly and to the reference's at the
  shmap_attention bars above.

The cases: gemma3-smoke "seqkv" with every leaf cut over its slots (M =
50: 25 positions a rank, rings of 32: 16 slots a rank); gemma3-smoke
"shmap" with a mixed cache (M = 49 keeps the kv-head cut, the rings are
cut over their slots); dbrx-smoke "seqkv" with a rank whose block stays
empty (a prompt of 10 in M = 48); dbrx-smoke "shmap" whose decode crosses
the block boundary at 24, so the owner of the new K / V changes. One
spawn of 2 ranks (`launch.mesh.spawn_ranks`; the rank functions in
torch_tp_ranks.py) and one reference subprocess for all of them.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro.models import layers as JL
from repro.models import zoo as JZ
from repro.serving import engine as JE
from repro_torch.kernels import ops
from repro_torch.kernels.swa_decode import kernel as swa_kernel
from repro_torch.kernels.swa_decode.ref import swa_decode_partial_ref
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import model_mesh, spawn_ranks
from repro_torch.models import layers as TL
from repro_torch.models.parallel import (ModelParallel, check_tp,
                                         combine_partials, local_slices)
from repro_torch.serving import engine as TE
from torch_parity import close, dense_model, flat_arrays, n, token_batch
import torch_tp_ranks

WORLD = 2
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 2e-4
TOKEN_MARGIN = 4e-4
CACHE_TOL = 1e-5
BF16_UNIT = 2.0 ** -7       # one bfloat16 unit, relative to the value
STATS_TOL = 1e-5
PARTIAL_RTOL = PARTIAL_ATOL = 1e-6
BATCH, STEPS = 2, 8
# name: (arch, variant, prompt, max_len)
ENGINE_CASES = {
    "gemma3-seqkv": ("gemma3-27b", "seqkv", 40, 50),
    "gemma3-shmap-mixed": ("gemma3-27b", "shmap", 40, 49),
    "dbrx-seqkv-empty-block": ("dbrx-132b", "seqkv", 10, 48),
    "dbrx-shmap-crossing": ("dbrx-132b", "shmap", 20, 48),
}
# shmap_attention: (B, Sq, H, Hkv, hd, Sk, causal, window, q_offset)
ATTN_CASES = {
    "causal": (2, 24, 4, 2, 16, 24, True, JL.NO_WINDOW, 0),
    "window": (2, 24, 4, 2, 16, 24, True, 7, 0),
    "bidirectional": (2, 24, 4, 4, 16, 24, False, JL.NO_WINDOW, 0),
    "last-queries": (1, 5, 4, 2, 16, 24, True, JL.NO_WINDOW, 19),
    "long": (1, 40, 2, 1, 32, 80, True, 33, 40),
}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = textwrap.dedent("""
    import dataclasses, functools, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro import configs as C
    from repro.models import layers as L
    from repro.models import zoo as Z
    from repro.serving import engine as E
    d = np.load(sys.argv[1])
    mesh = jax.make_mesh((1, 2), ("data", "model"))
    L.MESH = mesh
    out = {}
    for name in d["attn_names"]:
        causal, window, q_offset = (int(a) for a in d[f"{name}/flags"])
        fn = functools.partial(L.shmap_attention, causal=bool(causal),
                               window=window, q_offset=q_offset)
        with mesh:
            out[f"{name}/y"] = np.asarray(jax.jit(fn)(
                *(jnp.asarray(d[f"{name}/{a}"]) for a in "qkv")))
    for name in d["engine_names"]:
        arch = str(d[f"{name}/arch"])
        prompt, max_len, steps = (int(a) for a in d[f"{name}/sizes"])
        cfg = dataclasses.replace(C.get_smoke(arch), dtype=jnp.float32,
                                  attn_shard="shmap")
        params = {}
        for key in d.files:
            if key.startswith(f"{name}/p/"):
                node = params
                *path, leaf = key[len(name) + 3:].split("/")
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = jnp.asarray(d[key])
        tokens = jnp.asarray(d[f"{name}/tokens"], jnp.int32)
        b = tokens.shape[0]
        with mesh:
            out[f"{name}/forward"] = np.asarray(jax.jit(
                Z.forward, static_argnums=1)(params, cfg,
                                             {"tokens": tokens})[0])
            cache = E.init_cache(cfg, b, max_len)
            lg, cache = jax.jit(E.prefill, static_argnums=1)(
                params, cfg, {"tokens": tokens}, cache)
            decode = jax.jit(E.decode_step, static_argnums=1)
            logits, fed = [np.asarray(lg[:, -1])], []
            for i in range(steps):
                # the token and the cache cross the host between the
                # jitted calls: arrays made under the mesh carry shardings
                # that the next call's gather and cache writes refuse
                tok = np.asarray(jnp.argmax(lg[:, -1], axis=-1))[:, None]
                fed.append(tok)
                cache = {k: jnp.asarray(np.asarray(v))
                         for k, v in cache.items()}
                lg, cache = decode(params, cfg, jnp.asarray(tok, jnp.int32),
                                   cache, jnp.int32(prompt + i))
                logits.append(np.asarray(lg[:, -1]))
        out[f"{name}/logits"] = np.stack(logits)
        out[f"{name}/fed"] = np.stack(fed)
        for k, v in cache.items():
            out[f"{name}/cache/{k}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")

_decode = jax.jit(JE.decode_step, static_argnums=(1,))



def _unsharded(jp, jcfg, jb, prompt, max_len):
    """The reference's unsharded forward and engine: (forward logits, each
    step's last-position logits, the greedy tokens fed, the cache)."""
    fwd = np.asarray(JZ.forward(jp, jcfg, jb)[0])
    jc = JE.init_cache(jcfg, BATCH, max_len)
    jl, jc = JE.prefill(jp, jcfg, jb, jc)
    logits, fed = [np.asarray(jl[:, -1])], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
        fed.append(tok)
        jl, jc = _decode(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                         jnp.int32(prompt + i))
        logits.append(np.asarray(jl[:, -1]))
    return fwd, logits, fed, {k: np.asarray(v) for k, v in jc.items()}


def _attn_inputs(name):
    b, sq, h, hkv, hd, sk, *_ = ATTN_CASES[name]
    rng = np.random.default_rng(len(name))
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (the shmap ones in a subprocess, started
    first; the seqkv ones in this process) and the two ranks' results."""
    tmp = tmp_path_factory.mktemp("seq")
    models, feeds = {}, {}
    payload = {"attn_names": np.asarray(list(ATTN_CASES)),
               "engine_names": np.asarray(
                   [k for k, c in ENGINE_CASES.items() if c[1] == "shmap"])}
    for name in ATTN_CASES:
        _, _, _, _, _, _, causal, window, q_offset = ATTN_CASES[name]
        payload[f"{name}/flags"] = np.asarray([causal, window, q_offset])
        payload.update({f"{name}/{a}": x
                        for a, x in zip("qkv", _attn_inputs(name))})
    for name, (arch, variant, prompt, max_len) in ENGINE_CASES.items():
        jcfg, _, jp, _ = dense_model(arch)
        jb, tb = token_batch(jcfg, BATCH, prompt, seed=7)
        models[name] = (jcfg, jp, jb, n(tb["tokens"]))
        if variant == "shmap":
            payload[f"{name}/arch"] = np.asarray(arch)
            payload[f"{name}/sizes"] = np.asarray([prompt, max_len, STEPS])
            payload[f"{name}/tokens"] = n(tb["tokens"])
            payload.update({f"{name}/p/{k}": v for k, v in
                            flat_arrays(jax.device_get(jp)).items()})
    np.savez(tmp / "in.npz", **payload)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                             str(tmp / "in.npz"), str(tmp / "out.npz")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        refs = {}
        for name, (arch, variant, prompt, max_len) in ENGINE_CASES.items():
            if variant == "seqkv":
                jcfg, jp, jb, _ = models[name]
                refs[name] = _unsharded(jp, jcfg, jb, prompt, max_len)
        log, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    got = np.load(tmp / "out.npz")
    for name, (_, variant, _, _) in ENGINE_CASES.items():
        if variant == "shmap":
            refs[name] = (got[f"{name}/forward"], list(got[f"{name}/logits"]),
                          list(got[f"{name}/fed"]),
                          {k.split("/")[-1]: got[k] for k in got.files
                           if k.startswith(f"{name}/cache/")})
    engine_cases = [
        (arch, variant, jax.device_get(models[name][1]), models[name][3],
         refs[name][2], max_len)
        for name, (arch, variant, _, max_len) in ENGINE_CASES.items()]
    attn_cases = [(*_attn_inputs(name), *ATTN_CASES[name][6:])
                  for name in ATTN_CASES]
    ranks = spawn_ranks(WORLD, torch_tp_ranks.seq_tests_rank,
                        (engine_cases, attn_cases), device="cpu",
                        timeout_s=300)
    engine = {name: dict(ref=refs[name],
                         ranks=[r["engine"][i] for r in ranks])
              for i, name in enumerate(ENGINE_CASES)}
    attn = {name: dict(ref=got[f"{name}/y"],
                       ranks=[r["attn"][i] for r in ranks])
            for i, name in enumerate(ATTN_CASES)}
    return dict(engine=engine, attn=attn)


# ---------------------------------------------------------------------------
# K8's partials mode (no spawn)
# ---------------------------------------------------------------------------

def _cuts(s, n_blocks, rng):
    """n_blocks contiguous blocks covering [0, s), cut at random points."""
    edges = np.sort(rng.choice(np.arange(1, s), n_blocks - 1, replace=False))
    return list(zip([0, *edges], [*edges, s]))


@pytest.mark.parametrize("n_blocks", [1, 2, 3, 4])
@pytest.mark.parametrize("s,cache_len,window", [
    (300, 299, JK.NO_WINDOW), (300, 150, JK.NO_WINDOW), (300, 250, 64),
    (300, 0, JK.NO_WINDOW), (517, 400, 1)])
def test_partials_of_any_cut_combine_to_k8(n_blocks, s, cache_len, window):
    """Each block's partials over its part of (cache_len - window,
    cache_len] — an empty part included wherever a block lies wholly
    outside it — combined, equal the reference's swa_decode_ref and its
    interpreted Pallas kernel."""
    rng = np.random.default_rng(n_blocks * 1000 + cache_len)
    b, h, hkv, hd = 2, 8, 2, 64
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    lo_g, hi_g = max(0, cache_len - window + 1), cache_len + 1
    parts, empty = [], 0
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for a, z in _cuts(s, n_blocks, rng):
        lo, hi = min(max(lo_g - a, 0), z - a), min(max(hi_g - a, 0), z - a)
        empty += lo >= hi
        parts.append(swa_decode_partial_ref(tq, tk[:, a:z], tv[:, a:z], lo,
                                            hi))
    if n_blocks > 1 and cache_len in (0, 400):
        assert empty                    # one valid position: blocks empty
    got = n(combine_partials(None, *map(torch.stack, zip(*parts)),
                             torch.float32))
    for want in (JK.swa_decode_ref(q, k, v, cache_len, window),
                 JK.swa_decode(q, k, v, cache_len, window=window,
                               interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=PARTIAL_RTOL,
                                   atol=PARTIAL_ATOL)


def test_partial_of_an_empty_range_and_natural_log_units():
    """An empty range gives m = -inf, l = 0, acc = 0; a non-empty one m =
    the largest logit q.k / sqrt(hd) (natural-log units), l and acc
    relative to it."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 2, 64)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 5, 1, 64)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 5, 1, 64)).astype(np.float32))
    m, l, acc = ops.swa_decode_partial(q, k, v, 3, 3)
    assert torch.equal(m, torch.full((1, 2), -torch.inf))
    assert not l.any() and not acc.any() and acc.shape == (1, 2, 64)
    m, l, acc = ops.swa_decode_partial(q, k, v, 1, 4)
    logits = torch.einsum("bhd,bsd->bhs", q, k[:, 1:4, 0]) / 8.0
    close(m, logits.amax(-1))
    close(l, torch.exp(logits - m[..., None]).sum(-1))
    close(acc, torch.einsum("bhs,bsd->bhd", torch.exp(logits - m[..., None]),
                            v[:, 1:4, 0]))
    assert ops.launch_counts()["swa_decode_partial"] == 0


def test_partial_on_meta_reports_its_range_and_launches_nothing():
    """On `meta` tensors the partials mode launches nothing and reports
    the hi - lo slots' work (`swa_decode_range_work`) to the sink; an
    empty range reports no call and no work, as the card launches
    nothing for it."""
    q = torch.empty((4, 32, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((4, 514, 16, 128), dtype=torch.bfloat16, device="meta")
    seen = []
    with ops.kernel_work_sink(lambda *a: seen.append(a)):
        m, l, acc = ops.swa_decode_partial(q, k, k, 10, 514)
        ops.swa_decode_partial(q, k, k, 5, 5)
    assert [t.shape for t in (m, l, acc)] == [(4, 32), (4, 32),
                                             (4, 32, 128)]
    assert all(t.dtype == torch.float32 for t in (m, l, acc))
    [(name, nops, reads, _)] = seen
    assert name == "swa_decode_partial"
    assert nops == 4 * 4 * 32 * 504 * 128
    assert sum(r for _, r in reads) == 2 * 4 * 504 * 16 * 128 * 2 \
        + 4 * 32 * 128 * 2
    with pytest.raises(ValueError, match="outside the block"):
        ops.swa_decode_partial(q, k, k, 0, 515)


def test_partial_wrapper_plans_a_range_and_refuses_cpu_tensors():
    """The launch plan over a rank's range covers it once in one wave; the
    CUDA wrapper refuses CPU tensors (the plain version is ops' route)."""
    p = swa_kernel.plan_range(4, 32, 16, 0, 514, 132, 2, 64)
    assert p["n_split"] * p["split_len"] >= 514 > (p["n_split"] - 1) \
        * p["split_len"]
    assert p["waves"] == 1 and (p["lo"], p["hi"]) == (0, 514)
    assert swa_kernel.plan(4, 2056, 32, 16, 2055, ops.NO_WINDOW, 132, 2,
                           64) == swa_kernel.plan_range(4, 32, 16, 0, 2056,
                                                        132, 2, 64)
    with pytest.raises(ValueError, match="empty range"):
        swa_kernel.plan_range(4, 32, 16, 7, 7, 132, 2, 64)
    q, k = torch.zeros(1, 2, 64), torch.zeros(1, 5, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        swa_kernel.swa_decode_partial(q, k, k, 0, 5)


# ---------------------------------------------------------------------------
# blockwise_attention's stats (no spawn)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,q_offset,k_offset,chunk", [
    (True, JL.NO_WINDOW, 0, 0, 8), (True, JL.NO_WINDOW, 0, 12, 8),
    (True, 7, 0, 12, 5), (False, JL.NO_WINDOW, 0, 12, 8),
    (True, JL.NO_WINDOW, 19, 12, 4), (True, 20, 30, 40, 16)])
def test_blockwise_stats_match_the_reference(causal, window, q_offset,
                                             k_offset, chunk):
    """(m, l, acc) of a block of keys at k_offset equal the reference's
    within 1e-5 on every row that has a key in the block; a row with none
    has m = -1e30 on both sides (its l counts the reference's zero padding
    too, and its weight in the combine is 0)."""
    rng = np.random.default_rng(k_offset + chunk)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 24, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16)))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_chunk=chunk, k_offset=k_offset, return_stats=True)
    want = [np.asarray(a) for a in JL.blockwise_attention(q, k, v, **kw)]
    got = [n(a) for a in TL.blockwise_attention(
        *map(torch.from_numpy, (q, k, v)), **kw)]
    seen = want[0] > -1e29
    assert seen.any()
    np.testing.assert_array_equal(got[0] > -1e29, seen)
    assert np.all(got[0][~seen] == want[0][~seen])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g[seen], w[seen], rtol=STATS_TOL,
                                   atol=STATS_TOL)
    np.testing.assert_allclose(got[2][seen], want[2][seen], rtol=STATS_TOL,
                               atol=STATS_TOL)


# ---------------------------------------------------------------------------
# shmap_attention against the reference's shard_map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_shmap_attention_matches_the_reference(runs, name):
    """The bf16 wire: the ranks' outputs bit-equal, exactly the combine of
    their stats with acc rounded to bfloat16 before and after the sum, and
    the reference's within 1e-5 relative but for at most 0.1% of the
    elements within one bfloat16 unit (2^-7 of the value). The float32
    wire: the reference's dot attention within 1e-5."""
    r = runs["attn"][name]
    a, b = r["ranks"]
    wire = a[str(torch.bfloat16)]
    np.testing.assert_array_equal(wire, b[str(torch.bfloat16)])
    (m0, l0, c0), (m1, l1, c1) = (map(torch.from_numpy, r_["stats"])
                                  for r_ in (a, b))
    big = torch.maximum(m0, m1)
    s0, s1 = torch.exp(m0 - big), torch.exp(m1 - big)
    acc = ((c0 * s0[..., None]).to(torch.bfloat16).float()
           + (c1 * s1[..., None]).to(torch.bfloat16).float())
    want = (acc.to(torch.bfloat16).float()
            / torch.clamp(l0 * s0 + l1 * s1, min=1e-30)[..., None])
    np.testing.assert_array_equal(wire, n(want.transpose(1, 2)))
    ref = r["ref"]
    diff = np.abs(wire - ref)
    apart = diff > 1e-5 * np.abs(ref) + 1e-7
    assert np.all(diff[apart] <= 2.0 ** -7 * np.maximum(
        np.abs(wire), np.abs(ref))[apart])
    assert apart.mean() <= 1e-3, apart.sum()
    q, k, v = _attn_inputs(name)
    _, _, _, _, _, _, causal, window, q_offset = ATTN_CASES[name]
    plain = np.asarray(JL.dot_attention(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset))
    for rank in (a, b):
        close(rank[str(torch.float32)], plain, 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# The engine under "seqkv" and "shmap"
# ---------------------------------------------------------------------------

def _cfg(name):
    arch, variant, _, _ = ENGINE_CASES[name]
    return dataclasses.replace(torch_tp_ranks.smoke_cfg(arch),
                               attn_shard=variant)


def _layer_leaves(name) -> list[tuple[str, bool]]:
    """Each layer's cache leaf and whether it is a ring, in layer order."""
    cfg = _cfg(name)
    if not cfg.sliding_window:
        return [("k", False)] * cfg.n_layers
    return [("gk", False) if cfg.is_global_layer(i) else ("lk", True)
            for i in range(cfg.n_layers)]


def _seq_leaves(name) -> dict[str, bool]:
    """Leaf -> cut over its slots under the "seq" policy at WORLD ranks."""
    arch, _, _, max_len = ENGINE_CASES[name]
    shapes = TE.cache_shapes(_cfg(name), BATCH, max_len)
    lay = SH.cache_layouts(shapes, model_mesh(WORLD), policy="seq")
    return {k: s[-3] == "model" for k, s in lay.items()}


def _bars(name, want) -> tuple[float, float] | None:
    """(rtol, atol) of a "shmap" case's logits or cache against `want`:
    one bfloat16 unit of the largest |want| (module docstring); None under
    "seqkv", whose caller takes the float32 bars of test_torch_tp.py."""
    if ENGINE_CASES[name][1] == "shmap":
        return 0.0, BF16_UNIT * float(np.abs(want).max(initial=0.0))
    return None


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_seq_forward_matches_the_reference(runs, name):
    r = runs["engine"][name]
    bars = _bars(name, r["ref"][0]) or (LOGIT_RTOL, LOGIT_ATOL)
    for rank in r["ranks"]:
        close(rank["logits"], r["ref"][0], *bars)


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_seq_prefill_and_decode_match_the_reference(runs, name):
    r = runs["engine"][name]
    checked = 0
    for rank in r["ranks"]:
        assert len(rank["step_logits"]) == STEPS + 1
        for got, want in zip(rank["step_logits"], r["ref"][1]):
            bars = _bars(name, want)
            close(got, want, *(bars or (LOGIT_RTOL, LOGIT_ATOL)))
            margin = 2 * bars[1] if bars else TOKEN_MARGIN
            top2 = np.sort(want, axis=-1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > margin
            np.testing.assert_array_equal(got.argmax(-1)[sure],
                                          want.argmax(-1)[sure])
            checked += int(sure.sum())
    assert checked > 0


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_seq_cache_holds_each_ranks_block(runs, name):
    """Every leaf of each rank's cache is its part, under the "seq"
    layout, of the reference's cache after prefill and decode: a block of
    slots with every kv head where the ranks divide the leaf's slots, its
    kv heads where they do not (the mixed case's M = 49)."""
    r = runs["engine"][name]
    arch, _, prompt, max_len = ENGINE_CASES[name]
    cfg = _cfg(name)
    if cfg.sliding_window:
        assert prompt > cfg.sliding_window          # the rings wrapped
    shapes = TE.cache_shapes(cfg, BATCH, max_len)
    lay = SH.cache_layouts(shapes, model_mesh(WORLD), policy="seq")
    seq = _seq_leaves(name)
    if name == "gemma3-shmap-mixed":
        assert not seq["gk"] and seq["lk"]
    else:
        assert all(seq.values())
    for k, want in r["ref"][3].items():
        for rank_id, rank in enumerate(r["ranks"]):
            cut = tuple(slice(a, a + m) for a, m in local_slices(
                want.shape, lay[k], model_mesh(WORLD), rank_id))
            close(rank["cache"][k], want[cut],
                  *(_bars(name, want) or (CACHE_TOL, CACHE_TOL)))


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_seq_ranks_hold_the_same_logits_bits(runs, name):
    a, b = runs["engine"][name]["ranks"]
    np.testing.assert_array_equal(a["logits"], b["logits"])
    for x, y in zip(a["step_logits"], b["step_logits"]):
        np.testing.assert_array_equal(x, y)


def _want_calls(name, part) -> dict[str, int]:
    """The collectives of a forward, a prefill or one decode step: the
    embedding's all-reduce and the head's all-gather, two all-reduces a
    layer (wo and the MLP or the experts), and per layer what its
    attention adds: over fresh keys through shmap_attention an all-gather
    of q / k / v, the max and the combine (one float32 sum, or a bf16 wire
    and l: two); a prefill into a leaf cut over its slots an all-gather of
    k / v; a decode step there the gather, the max and one packed sum."""
    arch, variant, prompt, _ = ENGINE_CASES[name]
    layers = _layer_leaves(name)
    seq = _seq_leaves(name)
    sums = 2 if variant == "shmap" else 1
    want = {"all_reduce_sum": 1 + 2 * len(layers), "all_gather": 1,
            "all_reduce_max": 0}
    for leaf, ring in layers:
        shmap = prompt % WORLD == 0 and (
            part == "forward" or (part == "prefill" and variant == "shmap"
                                  and not ring))
        if shmap:
            want["all_gather"] += 1
            want["all_reduce_max"] += 1
            want["all_reduce_sum"] += sums
        elif part == "prefill" and seq[leaf]:
            want["all_gather"] += 1
        if part == "decode" and seq[leaf]:
            want["all_gather"] += 1
            want["all_reduce_max"] += 1
            want["all_reduce_sum"] += 1
    return {k: v for k, v in want.items() if v}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_seq_collectives_per_pass(runs, name):
    for rank in runs["engine"][name]["ranks"]:
        assert rank["calls"]["forward"] == _want_calls(name, "forward")
        assert rank["calls"]["prefill"] == _want_calls(name, "prefill")
        for calls in rank["step_calls"]:
            assert calls == _want_calls(name, "decode")


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_seq_decode_runs_k8_partials_over_each_ranks_range(runs, name):
    """Each decode step calls K8's partials mode once per layer whose
    leaf is cut over its slots, over the rank's part of the valid slots:
    the empty-block case's rank 1 has an empty range at every step (no
    launch on the card), the crossing case's rank 1 a non-empty one from
    the step whose position reaches its block."""
    arch, variant, prompt, max_len = ENGINE_CASES[name]
    seq = _seq_leaves(name)
    cfg = _cfg(name)
    for rank_id, rank in enumerate(runs["engine"][name]["ranks"]):
        for i, ranges in enumerate(rank["step_ranges"]):
            pos = prompt + i
            want = []
            for leaf, ring in _layer_leaves(name):
                if not seq[leaf]:
                    continue
                total = (min(cfg.sliding_window, max_len) if ring
                         else max_len)
                nb = total // WORLD
                hi = min(pos, total - 1) + 1 if ring else pos + 1
                want.append((min(max(-rank_id * nb, 0), nb),
                             min(max(hi - rank_id * nb, 0), nb)))
            assert want and [tuple(r) for r in ranges] == want, (rank_id, i)
    one = runs["engine"][name]["ranks"][1]["step_ranges"]
    if name == "dbrx-seqkv-empty-block":
        assert all(tuple(r) == (0, 0) for step in one for r in step)
    if name == "dbrx-shmap-crossing":
        assert tuple(one[0][0]) == (0, 0) and tuple(one[-1][0]) == (0, 4)


# ---------------------------------------------------------------------------
# Layouts and refusals (no spawn)
# ---------------------------------------------------------------------------

def _rank(r: int, world: int) -> ModelParallel:
    return ModelParallel(rank=r, world=world, mesh=model_mesh(world),
                         backend="gloo")


@pytest.mark.parametrize("arch,max_len", [("gemma3-27b", 50),
                                          ("gemma3-27b", 49),
                                          ("dbrx-132b", 48)])
def test_local_cache_shapes_under_the_seq_policy(arch, max_len):
    """Each leaf's local shape is the rank's part under
    `cache_layouts(policy="seq")`: a block of slots with every kv head
    where WORLD divides the slots, the kv-head cut where it does not; an
    attn_shard of "seqkv" or "shmap" gives init_cache the "seq" layout,
    "auto" the "heads" one."""
    cfg = dataclasses.replace(torch_tp_ranks.smoke_cfg(arch),
                              attn_shard="seqkv")
    full = TE.cache_shapes(cfg, BATCH, max_len)
    lay = SH.cache_layouts(full, model_mesh(WORLD), policy="seq")
    for r in range(WORLD):
        local = TE.local_cache_shapes(cfg, BATCH, max_len, _rank(r, WORLD))
        for k, (shape, dt) in full.items():
            if shape[-3] % WORLD == 0:
                want = shape[:-3] + (shape[-3] // WORLD,) + shape[-2:]
            else:
                want = shape[:-2] + (shape[-2] // WORLD, shape[-1])
            assert local[k] == (want, dt)
            assert tuple(m for _, m in local_slices(
                shape, lay[k], model_mesh(WORLD), r)) == want
    heads = SH.cache_layouts(full, model_mesh(WORLD), policy="heads")
    for variant, policy in (("auto", "heads"), ("seqkv", "seq"),
                            ("shmap", "seq")):
        vcfg = dataclasses.replace(cfg, attn_shard=variant)
        assert TE.cache_policy(vcfg) == policy
        cache = TE.init_cache(vcfg, BATCH, max_len, device="cpu",
                              mp=_rank(1, WORLD))
        want = {k: (tuple(m for _, m in local_slices(
            shape, (lay if policy == "seq" else heads)[k], model_mesh(WORLD),
            1)), dt) for k, (shape, dt) in full.items()}
        assert {k: (tuple(t.shape), t.dtype) for k, t in cache.items()} \
            == TE.local_cache_shapes(vcfg, BATCH, max_len,
                                     _rank(1, WORLD)) == want


def test_seq_variants_refuse_an_unknown_attn_shard():
    cfg = dataclasses.replace(torch_tp_ranks.smoke_cfg("dbrx-132b"),
                              attn_shard="ring")
    with pytest.raises(ValueError, match="attn_shard"):
        check_tp(cfg, 2)
    check_tp(dataclasses.replace(cfg, attn_shard="seqkv"), 2)


def test_seq_cut_reads_the_leaf_not_the_variant():
    """A leaf is cut over its slots iff its layout tag, set where the
    cache is laid out (`engine.cache_cuts`, `KVCache.cuts`), is "seq"
    under more than one rank. This read the leaf's shape (every kv head:
    "seq") before the tag; a rank holding every kv head under "heads"
    (MQA) is now told apart. The variant alone decides nothing: a leaf
    whose slots the ranks do not divide stays "heads" under "seqkv"."""
    assert TL.seq_cut(_rank(0, 2), "seq")
    assert not TL.seq_cut(_rank(0, 2), "heads")
    assert not TL.seq_cut(None, "seq")
    assert not TL.seq_cut(_rank(0, 1), "seq")
    cfg = dataclasses.replace(torch_tp_ranks.smoke_cfg("yi-34b"),
                              attn_shard="seqkv", n_kv_heads=1)
    assert TE.cache_cuts(cfg, 2, 48, _rank(0, 2)) == {"k": "seq",
                                                      "v": "seq"}
    assert TE.cache_cuts(cfg, 2, 49, _rank(0, 2)) == {"k": "heads",
                                                      "v": "heads"}
    cache = TE.init_cache(cfg, 2, 49, device="cpu", mp=_rank(1, 2))
    assert cache.cuts == {"k": "heads", "v": "heads"}
    assert cache["k"].shape[-2] == cfg.n_kv_heads

