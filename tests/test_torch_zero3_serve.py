"""Serving under the reference's "zero3" layout (its dry run's `--variant
zero3` prefill and decode): each rank holds its zero3 shard (every weight
cut on its `embed` dim over all the mesh's axes, the experts over
"model"); the engine gathers a sublayer's weights where it runs them,
narrows them to the rank's "tp" pieces and runs the "tp" layer code
(`engine.serve_weights`), so the cache is the "tp" cache (the reference's
`cache_shardings(policy="heads")`, which its zero3 serving uses).

On gloo ranks on the CPU (`torch_tp_ranks.zero3_serve_rank`, one spawn
per mesh, (2, 2) and (1, 4)), each family's smoke config in float32 with
the reference's params perturbed as tests/test_torch_tp_families.py's
(yi-, gemma3- (its rings wrap), starcoder2- (2 kv heads over 4 ranks),
dbrx-, rwkv6- in both ssm_impl forms, zamba2- and seamless-smoke), 2 rows
x 40 prompt tokens and 8 greedy decode steps, against the reference's
unsharded `repro.serving.engine` run at tests/test_torch_tp.py's bars:
logits rtol 1e-5 / atol 2e-4, greedy tokens exact where the reference's
top-2 margin exceeds 4e-4. The same rank's "tp" run on the same rows gives
the same cache bits, leaf by leaf, and logits within 1e-5 (zero3's head
sums float32 partials), its cache the same bytes
(`engine.local_cache_shapes`), K8 the same calls.

Collectives a pass, per rank: "tp"'s layer collectives, plus one
all-gather per read of a layer's leaf the zero3 layout cuts (over all the
mesh's N > 1 ranks), each putting in the rank's block of it: at prefill
every cut leaf of a layer per layer (the encoder's per encoder layer,
zamba2's shared block's per application); at decode the same but the
encoder and seamless's cross wk / wv (the cached cross K/V stand in for
them). No rank gathers the head, nor the embedding where the batch's
tokens are fewer than its rows, as here (`parallel.gathered_lookup`,
`gathered_logits`): in place of "tp"'s vocabulary-cut embedding sum and
logits gather, one all-gather of the looked-up rows, one all-reduce of
the float32 partial logits, and over "data" one all-gather each of the
tokens and of the head's input. At most one
layer's gathered weights are alive at once, on the ranks and in the
meta trace. On `meta` over the counting transport (`launch.dryrun`) each
rank's trace counts what the gloo rank counts, and on a 2 x 4 mesh the
classes of ranks (`dryrun.rank_classes`, from the zero3 and the "tp"
pieces) give every rank's record for a zero3 decode step of each family.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import engine as JE
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import spawn_ranks, train_mesh
from repro_torch.models import parallel as TPAR
from repro_torch.models import zoo as TZ
from repro_torch.serving import engine as TE
from torch_parity import close, perturbed_model, token_batch
import torch_tp_ranks

LOGIT_RTOL, LOGIT_ATOL = 1e-5, 2e-4
TOKEN_MARGIN = 4e-4
PROMPT, STEPS, BATCH = 40, 8, 2
MESHES = [(2, 2), (1, 4)]
# name -> (arch, ssm_impl)
CASES = {
    "yi": ("yi-34b", "scan"),
    "gemma3": ("gemma3-27b", "scan"),
    "starcoder2": ("starcoder2-3b", "scan"),
    "dbrx": ("dbrx-132b", "scan"),
    "rwkv6-scan": ("rwkv6-1.6b", "scan"),
    "rwkv6-chunked": ("rwkv6-1.6b", "chunked"),
    "zamba2": ("zamba2-1.2b", "scan"),
    "seamless": ("seamless-m4t-large-v2", "scan"),
}
RUNS = [(name, mesh) for mesh in MESHES for name in CASES]

_decode = jax.jit(JE.decode_step, static_argnums=(1,))


def _id(case):
    name, (d, m) = case
    return f"{name}-{d}x{m}"


def _serve(jp, jcfg, jb, max_len, enc_len):
    """The reference's prefill and STEPS greedy decode steps: each step's
    last-position logits and the tokens it fed."""
    jc = JE.init_cache(jcfg, BATCH, max_len, enc_len)
    jl, jc = JE.prefill(jp, jcfg, jb, jc)
    logits, fed = [np.asarray(jl[:, -1])], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
        fed.append(tok)
        jl, jc = _decode(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                         jnp.int32(PROMPT + i))
        logits.append(np.asarray(jl[:, -1]))
    return logits, fed


@pytest.fixture(scope="module")
def runs():
    refs, cases = {}, []
    for name, (arch, impl) in CASES.items():
        jcfg, jp = perturbed_model(arch, impl)
        jb, tb = token_batch(jcfg, BATCH, PROMPT, seed=7)
        enc_len = (tb["frontend"].shape[1] if jcfg.arch_type == "encdec"
                   else 0)
        max_len = PROMPT + STEPS + 1
        steps, fed = _serve(jp, jcfg, jb, max_len, enc_len)
        cfg = dataclasses.replace(torch_tp_ranks.smoke_cfg(arch),
                                  ssm_impl=impl)
        refs[name] = dict(cfg=cfg, steps=steps, max_len=max_len,
                          enc_len=enc_len)
        cases.append((name, arch, impl, jax.device_get(jp),
                      tb["tokens"].numpy(),
                      tb["frontend"].numpy() if "frontend" in tb else None,
                      fed, max_len))
    ranks = {mesh: spawn_ranks(mesh[0] * mesh[1],
                               torch_tp_ranks.zero3_serve_rank, (cases,),
                               mesh=train_mesh(*mesh), device="cpu",
                               timeout_s=600)
             for mesh in MESHES}
    return refs, ranks


def _case(runs, case):
    name, mesh = case
    refs, ranks = runs
    return refs[name], [r[name] for r in ranks[mesh]]


def _rows(mesh, r):
    """The rows of the batch global rank r holds (`batch_rows`)."""
    d, m = mesh
    n = BATCH // d
    return slice((r // m) * n, (r // m + 1) * n)


@pytest.mark.parametrize("case", RUNS, ids=_id)
def test_zero3_prefill_and_decode_match_the_reference(runs, case):
    ref, got = _case(runs, case)
    checked = 0
    for r, rank in enumerate(got):
        assert rank["zero3"]["round_trip"] and rank["tp"]["round_trip"]
        rows = _rows(case[1], r)
        for a, want in zip(rank["zero3"]["step_logits"], ref["steps"]):
            want = want[rows]
            close(a, want, LOGIT_RTOL, LOGIT_ATOL)
            top2 = np.sort(want, axis=-1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > TOKEN_MARGIN
            np.testing.assert_array_equal(a.argmax(-1)[sure],
                                          want.argmax(-1)[sure])
            checked += int(sure.sum())
    assert checked > 0


@pytest.mark.parametrize("case", RUNS, ids=_id)
def test_zero3_serving_is_tp_serving(runs, case):
    """The rank's zero3 run and its "tp" run on the same rows: the same
    cache, leaf by leaf, bit for bit (the layers run the same code on the
    same weights, the lookup gives the table's bits), and logits within
    1e-5 (zero3's head sums its ranks' float32 partial logits)."""
    _, got = _case(runs, case)
    for rank in got:
        z, t = rank["zero3"], rank["tp"]
        for a, b in zip(z["step_logits"], t["step_logits"]):
            close(a, b, 1e-5, 1e-5)
        assert sorted(z["cache"]) == sorted(t["cache"])
        for k in z["cache"]:
            np.testing.assert_array_equal(z["cache"][k], t["cache"][k])


@pytest.mark.parametrize("case", RUNS, ids=_id)
def test_zero3_cache_is_the_tp_cache(runs, case):
    """Each rank's cache: the "tp" layout's shapes and bytes
    (`local_cache_shapes` of its rows)."""
    ref, got = _case(runs, case)
    mesh = train_mesh(*case[1])
    for r, rank in enumerate(got):
        mp = TPAR.ModelParallel.counting(mesh, r)
        want = TE.local_cache_shapes(ref["cfg"], BATCH // case[1][0],
                                     ref["max_len"], mp, ref["enc_len"])
        cache = rank["zero3"]["cache"]
        assert {k: (tuple(v.shape), v.dtype.itemsize)
                for k, v in cache.items()} == {
            k: (s, dt.itemsize) for k, (s, dt) in want.items()}
        assert sum(v.nbytes for v in cache.values()) == sum(
            math.prod(s) * dt.itemsize for s, dt in want.values())


def _cut_reads(cfg, specs, step) -> list[tuple[str, int]]:
    """(path, times read) of every layer's leaf the zero3 layout cuts, as
    a pass reads it (the module docstring)."""
    per = {"blocks": cfg.n_layers,
           "enc_blocks": cfg.n_enc_layers if step == "prefill" else 0,
           "shared_attn": (TZ.shared_applications(cfg)
                           if cfg.arch_type == "hybrid" else 0)}
    out = []
    for path, spec in _leaf_paths(specs):
        top = path.split("/")[0]
        if TPAR.data_cut(spec) is None or top in ("embed", "head"):
            continue
        if step == "decode" and path in ("blocks/cross/wk",
                                         "blocks/cross/wv"):
            continue
        out.append((path, per[top]))
    return out


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def _zero3_calls(cfg, mesh, tp_calls: dict, step: str) -> dict:
    """A zero3 pass's collective calls from the "tp" pass's (the module
    docstring): "tp"'s layer collectives; no vocabulary-cut embedding sum
    or logits gather; the lookup's gather of the rows (and of the tokens
    over "data"), the head's sum of the partial logits (and gather of x
    over "data"); one all-gather per read of a layer's cut leaf."""
    d, m = mesh.sizes
    out = dict(tp_calls)
    vocab = int(cfg.vocab % m == 0 and m > 1)
    reads = sum(n for _, n in _cut_reads(
        cfg, SH.param_layouts(TZ.templates(cfg), mesh, "zero3"), step))
    out["all_gather"] = (out.get("all_gather", 0) - vocab + 1 + 2 * (d > 1)
                         + reads)
    out["all_reduce_sum"] = out.get("all_reduce_sum", 0) - vocab + 1
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("case", RUNS, ids=_id)
def test_zero3_collectives_are_tp_s_and_the_gathers(runs, case):
    ref, got = _case(runs, case)
    mesh = train_mesh(*case[1])
    for rank in got:
        z, t = rank["zero3"], rank["tp"]
        for label, zs, ts in [("prefill", [z["prefill"]], [t["prefill"]]),
                              ("decode", z["decode"], t["decode"])]:
            for zc, tc in zip(zs, ts):
                assert zc["k8"] == tc["k8"] and zc["k8_partial"] == 0
                assert zc["calls"] == _zero3_calls(ref["cfg"], mesh,
                                                   tc["calls"], label), label
        if ref["cfg"].arch_type != "ssm":
            assert z["decode"][0]["k8"] > 0


def _one_layer_bytes(cfg) -> int:
    """The most bytes of gathered weights alive at once allowed: one
    layer's cut leaves whole (of "blocks" or "enc_blocks") or zamba2's
    shared block, float32, beside the prefill's gathered rows of the
    embedding (the whole batch's)."""
    tmpl = TZ.templates(cfg)
    specs = SH.param_layouts(tmpl, train_mesh(2, 2), "zero3")
    units: dict = {}
    for (path, t), (_, spec) in zip(_leaf_paths(tmpl), _leaf_paths(specs)):
        top = path.split("/")[0]
        if TPAR.data_cut(spec) is None or top in ("embed", "head"):
            continue
        shape = t.shape[1:] if top in ("blocks", "enc_blocks") else t.shape
        units[top] = units.get(top, 0) + math.prod(shape) * 4
    return max(units.values()) + BATCH * PROMPT * cfg.d_model * 4


@pytest.mark.parametrize("case", RUNS, ids=_id)
def test_zero3_holds_at_most_one_layers_gathered_weights(runs, case):
    """The most bytes of gathered weights alive at once on a rank, over
    its prefill and decode steps: no more than one layer's (or the
    embedding's, the head's, zamba2's shared block's) whole."""
    ref, got = _case(runs, case)
    bound = _one_layer_bytes(ref["cfg"])
    for rank in got:
        assert 0 < rank["zero3"]["live_gathered"] <= bound
        assert rank["tp"]["live_gathered"] == 0


def _meta_record(cfg, step, mesh, r, enc_len, **kw):
    layout = TPAR.TrainLayout("zero3", SH.param_layouts(TZ.templates(cfg),
                                                        mesh, "zero3"))
    mp = TPAR.ModelParallel.counting(mesh, r)
    live = torch_tp_ranks._live_gathered(mp)
    rec = D.rank_record(cfg, step, mp, layout=layout, enc_len=enc_len,
                        param_dtype=torch.float32, **kw)
    live.undo()
    return rec, live.peak


@pytest.mark.parametrize("name", CASES)
def test_zero3_meta_trace_counts_what_the_ranks_count(runs, name):
    """Every rank of the 2 x 2 run: its meta trace of the prefill and of
    each decode step counts the gloo rank's collectives and K8 calls, and
    holds at most one layer's gathered weights at once."""
    refs, ranks = runs
    ref = refs[name]
    cfg, mesh = ref["cfg"], train_mesh(2, 2)
    bound = _one_layer_bytes(cfg)
    for r in range(mesh.size):
        real = ranks[(2, 2)][r][name]["zero3"]
        passes = [("prefill", real["prefill"],
                   dict(batch=BATCH, seq_len=PROMPT,
                        max_len=ref["max_len"]))]
        passes += [("decode", counts,
                    dict(batch=BATCH, seq_len=ref["max_len"],
                         max_len=ref["max_len"], cache_len=PROMPT + i))
                   for i, counts in enumerate(real["decode"])]
        for step, counts, kw in passes:
            rec, peak = _meta_record(cfg, step, mesh, r, ref["enc_len"],
                                     **kw)
            k8 = rec["kernel_calls"]
            assert dict(calls=rec["calls"], bytes=rec["bytes"],
                        k8=k8.get("swa_decode", 0),
                        k8_partial=k8.get("swa_decode_partial", 0)) == \
                counts, (step, r)
            assert 0 < peak <= bound


def _comparable(rec) -> dict:
    return {k: v for k, v in rec.items() if k not in ("trace_s", "ranks")}


@pytest.mark.parametrize("name", CASES)
def test_zero3_decode_classes_give_every_ranks_record(name):
    """On a 2 x 4 smoke mesh, a zero3 decode step of each family: the
    classes of ranks cover every rank once, and each class's record is
    the record of tracing each of its ranks."""
    arch, impl = CASES[name]
    cfg = dataclasses.replace(torch_tp_ranks.smoke_cfg(arch), ssm_impl=impl)
    mesh = train_mesh(2, 4)
    enc = 8 if cfg.arch_type == "encdec" else 0
    kw = dict(batch=4, seq_len=16, max_len=16, cache_len=12, enc_len=enc,
              param_dtype=torch.float32)
    layout = TPAR.TrainLayout("zero3", SH.param_layouts(TZ.templates(cfg),
                                                        mesh, "zero3"))
    every = [D.rank_record(cfg, "decode", TPAR.ModelParallel.counting(mesh, r),
                           layout=layout, **kw) for r in range(mesh.size)]
    classes = D.rank_class_records(cfg, "decode", mesh, mode="zero3", **kw)
    assert sorted(r for c in classes for r in c["ranks"]) == \
        list(range(mesh.size))
    for c in classes:
        for r in c["ranks"]:
            assert _comparable(c) == _comparable(every[r]), r
    assert every[0]["calls"]["all_gather"] > 0


def test_zero3_lookup_moves_the_fewer_bytes():
    """A zero3 prefill gathers the tokens' rows where the batch has fewer
    tokens than the table has rows (yi-smoke, 2 x 40 of 512), else the
    table, as a layer's leaves are gathered (2 x 300): on the counting
    transport the long prefill's all-gathers put in the table's block
    and not the tokens and their rows."""
    cfg = torch_tp_ranks.smoke_cfg("yi-34b")
    mesh = train_mesh(2, 2)
    layout = TPAR.TrainLayout("zero3", SH.param_layouts(TZ.templates(cfg),
                                                        mesh, "zero3"))
    got = {}
    for s in (40, 300):
        rec = D.rank_record(cfg, "prefill",
                            TPAR.ModelParallel.counting(mesh, 0), batch=2,
                            seq_len=s, layout=layout,
                            param_dtype=torch.float32)
        got[s] = rec["bytes"]["all_gather"]
    block = cfg.d_model // mesh.size
    rows = 2 * 40 * block * 4 + 1 * 40 * 4      # every row's block; tokens
    assert got[300] - got[40] == cfg.vocab * block * 4 - rows


def test_engine_refuses_a_layout_it_does_not_serve():
    """"fsdp" is a training layout: the engine refuses it, and a layout
    without ranks."""
    cfg = torch_tp_ranks.smoke_cfg("yi-34b")
    mesh = train_mesh(2, 2)
    mp = TPAR.ModelParallel.counting(mesh, 0)
    fsdp = TPAR.TrainLayout("fsdp", SH.param_layouts(TZ.templates(cfg), mesh,
                                                     "fsdp"))
    with pytest.raises(ValueError, match="fsdp"):
        TE.serve_weights(cfg, mp, fsdp)
    zero3 = dataclasses.replace(fsdp, mode="zero3")
    with pytest.raises(ValueError, match="without ranks"):
        TE.serve_weights(cfg, None, zero3)
    with pytest.raises(ValueError, match="serves over ranks"):
        D.rank_class_records(cfg, "decode", mesh, batch=2, seq_len=8,
                             mode="fsdp")


@pytest.mark.slow
def test_pod_record_traces_zero3_decode():
    """The pod dry run no longer skips a zero3 serving step: yi-34b's
    decode at the reference's 256-chip mesh on the counting transport,
    its headline the slowest class, every class a zero3 rank's (the
    gathers counted)."""
    rec = D.pod_record("yi-34b", "decode_32k", variant="zero3")
    assert rec["status"] == "ok" and rec["shard_mode"] == "zero3"
    assert sum(len(c["ranks"]) for c in rec["classes"]) == 256
    assert all(c["calls"]["all_gather"] > 0 for c in rec["classes"])
    assert rec["kernel_calls"]["swa_decode"] == 60
