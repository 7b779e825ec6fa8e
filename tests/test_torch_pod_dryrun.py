"""The pod dry run (`repro_torch.launch.dryrun --pod`): one rank's step
traced on `meta` tensors over the counting transport
(`ModelParallel.counting`), on the CPU against real ranks and against the
reference's compiled step.

  * Counts: a rank's meta trace counts the collectives (calls and bytes
    put in, by kind) and K8's calls (whole, and partials over a non-empty
    range: the card launches none for an empty one) that the same rank
    counts when it runs the step over gloo (`torch_tp_ranks.pod_rank`,
    random weights: nothing counted depends on them), rank by rank and
    pass by pass: the serving cases over 4 ranks, the training cases over
    2 x 2. The classes of ranks (`dryrun.rank_classes`) give the records
    of tracing every rank.
  * The reference (one subprocess with 4 host devices, the reference's
    steps jitted with `repro.launch.sharding`'s shardings on a 2 x 2
    mesh, as its dry run lowers them, `keep_unused=True` so that an input
    the step does not read still counts, as it does on a rank): per-device
    argument bytes equal the port's rank's, but for the leaves the port
    holds otherwise (`parallel.rank_pieces`: Mamba2's B / C columns whole;
    the cache's conv state likewise, RWKV-6's shift states whole) and the
    decode's cache_len, a 4-byte argument there and a host int here, each
    computed and asserted to the byte; dot FLOPs of the dense and encdec
    families' prefill and decode under "tp" equal its `HloCost` exactly;
    the variant and shard mode the port picks equal its
    `recommended_variant` / `_shard_mode` for every arch x shape (its
    `launch/dryrun.py` sets 512 host devices when imported, so only that
    subprocess imports it).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

import torch_tp_ranks as R
from repro_torch import configs as TCFG
from repro_torch.configs import shapes as TSH
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import (model_mesh, production_mesh,
                                     spawn_ranks, train_mesh)
from repro_torch.models import base as MB
from repro_torch.models import parallel as TPAR
from repro_torch.models import zoo as Z
from repro_torch.serving import engine as E
from test_torch_dryrun import OuterProducts

REPO = Path(__file__).resolve().parents[1]
B, S, STEPS, MAX_LEN, ENC = 2, 8, 2, 16, 8
YI6 = {"n_heads": 6, "head_dim": 64}
# the ranks touch 1, 2, 2 and 1 of its 3 query heads: two classes
YI3 = {"n_heads": 3, "n_kv_heads": 3, "head_dim": 64}
# (name, arch, overrides, variant, batch, prompt, steps, max_len, frames)
SERVE = [(f"{key}/{v}", arch, ov, v, B, S, STEPS, MAX_LEN,
          ENC if arch.startswith("seamless") else 0)
         for key, arch, ov, variants in (
             ("starcoder2", "starcoder2-3b", {}, ("auto", "seqkv", "shmap")),
             ("yi6", "yi-34b", YI6, ("auto", "seqkv", "shmap")),
             ("yi3", "yi-34b", YI3, ("auto", "seqkv")),
             ("zamba2", "zamba2-1.2b", {}, ("auto", "seqkv")),
             ("seamless", "seamless-m4t-large-v2", {}, ("auto", "seqkv")))
         for v in variants]
# (name, arch, overrides, mode, batch, seq)
TRAIN = [(f"{key}/{mode}{'+shmap' if shmap else ''}", arch,
          dict(ov, attn_shard="shmap" if shmap else "auto"), mode, 4, S)
         for key, arch, ov in (("yi", "yi-34b", {}),
                               ("dbrx", "dbrx-132b",
                                {"capacity_factor": 1.0}))
         for mode, shmap in (("tp", False), ("fsdp", False),
                             ("zero3", False), ("fsdp", True))]


def serve_cfg(case):
    _, arch, ov, variant, *_ = case
    return dataclasses.replace(R.smoke_cfg(arch), attn_shard=variant, **ov)


def train_cfg(case):
    return dataclasses.replace(R.smoke_cfg(case[1]), **case[2])


def serve_passes(case):
    """The meta traces' arguments of each pass of a serve case: (label,
    step, rank_record keywords)."""
    _, _, _, _, b, s, steps, max_len, enc = case
    out = [("prefill", "prefill", dict(batch=b, seq_len=s, max_len=max_len,
                                       enc_len=enc))]
    out += [(i, "decode", dict(batch=b, seq_len=max_len, max_len=max_len,
                               cache_len=s + i, enc_len=enc))
            for i in range(steps)]
    return out


def counted(rec) -> dict:
    """A meta record's counts as `torch_tp_ranks._pass_counts` gives a
    real rank's."""
    k8 = rec["kernel_calls"]
    return dict(calls=rec["calls"], bytes=rec["bytes"],
                k8=k8.get("swa_decode", 0),
                k8_partial=k8.get("swa_decode_partial", 0))


def comparable(rec) -> dict:
    return {k: v for k, v in rec.items() if k not in ("trace_s", "ranks")}


@pytest.fixture(scope="module")
def serve_ranks():
    return spawn_ranks(4, R.pod_rank, (SERVE, ()), device="cpu",
                       mesh=model_mesh(4))


@pytest.fixture(scope="module")
def train_ranks():
    return spawn_ranks(4, R.pod_rank, ((), TRAIN), device="cpu",
                       mesh=train_mesh(2, 2))


@pytest.mark.parametrize("case", SERVE, ids=[c[0] for c in SERVE])
def test_serve_counts_equal_the_ranks(case, serve_ranks):
    """Every pass of every rank: the meta trace's collectives and K8 calls
    equal the gloo rank's; the classes' records equal every rank's."""
    cfg = serve_cfg(case)
    mesh = model_mesh(4)
    for label, step, kw in serve_passes(case):
        every = [D.rank_record(cfg, step, TPAR.ModelParallel.counting(mesh, r),
                               param_dtype=torch.float32, **kw)
                 for r in range(4)]
        for r, rec in enumerate(every):
            real = serve_ranks[r][case[0]]
            got = real["prefill"] if label == "prefill" else \
                real["decode"][label]
            assert counted(rec) == got, (case[0], label, r)
        classes = D.rank_class_records(cfg, step, mesh,
                                       param_dtype=torch.float32, **kw)
        assert sorted(r for c in classes for r in c["ranks"]) == [0, 1, 2, 3]
        for c in classes:
            for r in c["ranks"]:
                assert comparable(c) == comparable(every[r]), (label, r)
    if case[0] == "yi3/auto":
        assert [c["ranks"] for c in classes] == [[0, 3], [1, 2]]


@pytest.mark.parametrize("case", TRAIN, ids=[c[0] for c in TRAIN])
def test_train_counts_equal_the_ranks(case, train_ranks):
    """An Adam step of every rank of a 2 x 2 mesh: the meta trace's
    collectives equal the gloo rank's (no K8 on a train step); the
    classes' records equal every rank's."""
    cfg, mesh, mode = train_cfg(case), train_mesh(2, 2), case[3]
    layout = TPAR.TrainLayout(mode, SH.param_layouts(Z.templates(cfg), mesh,
                                                     mode))
    every = [D.rank_record(cfg, "train", TPAR.ModelParallel.counting(mesh, r),
                           batch=case[4], seq_len=case[5], layout=layout,
                           param_dtype=torch.float32) for r in range(4)]
    for r, rec in enumerate(every):
        assert counted(rec) == train_ranks[r][case[0]]["train"], (case[0], r)
    for c in D.rank_class_records(cfg, "train", mesh, batch=case[4],
                                  seq_len=case[5], mode=mode,
                                  param_dtype=torch.float32):
        for r in c["ranks"]:
            assert comparable(c) == comparable(every[r]), r


@pytest.mark.parametrize("mode", ["fsdp", "zero3"])
def test_weight_gathered_train_step_traces_on_meta(mode):
    """`regather_saved` knows a gathered weight by its storage's identity:
    on `meta` every data pointer reads 0, and keyed by it every tensor an
    op saved was taken for a gathered weight (the backward then failed:
    "expected predicate to be bool")."""
    cfg, mesh = R.smoke_cfg("yi-34b"), train_mesh(2, 2)
    layout = TPAR.TrainLayout(mode, SH.param_layouts(Z.templates(cfg), mesh,
                                                     mode))
    rec = D.rank_record(cfg, "train", TPAR.ModelParallel.counting(mesh, 0),
                        batch=4, seq_len=S, layout=layout)
    assert rec["calls"]["all_gather"] and rec["calls"]["reduce_scatter"]


# -- against the reference's compiled step -----------------------------------

_REFERENCE = r"""
import dataclasses, json, math, re, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.launch import dryrun as JD     # sets 512 host devices
import repro.configs as JCFG
from repro.configs import shapes as JSH
from repro.launch import roofline as JR
from repro.launch import sharding as SHD
from repro.models import base as JMB
from repro.models import zoo as JZ
from repro.optim import adam
from repro.serving import engine as JE


# each collective of the compiled step with its trips: [trips, kind,
# [[dtype, elements] per result], group size, HloCost saw it, under a
# rematerialized computation]; the dot FLOPs that the rematerialized
# layers recompute in the backward; and those of XLA's transposes of the
# outer-product einsums (rwkv6's k v^T, mamba2's dt x B^T), each a
# multiply in the port
OUTER = ("/bhk,bhv->bhkv/", "/bhp,bn,bh->bhpn/")


def itemized(text, cost):
    trips = {}

    def walk(comp, n, depth=0):
        if depth > 128:
            return
        trips[comp] = trips.get(comp, 0) + n
        for callee, k in cost._calls.get(comp, []):
            walk(callee, n * k, depth + 1)
    walk(cost.entry, 1)
    coll = re.compile(r"^\s*%?[\w.\-]+ = (.*?) (all-reduce|all-gather|"
                      r"reduce-scatter|all-to-all|collective-permute)"
                      r"(?:-start)?\(")
    shapes, items, remat, outer, comp = {}, [], 0, 0, None
    for line in text.splitlines():
        mdef = JR._COMP_DEF_RE.match(line)
        if mdef and "=" not in line.split("(")[0]:
            comp = mdef.group(2)
            continue
        n = trips.get(comp, 0)
        seen = JR._OP_DEF_RE.match(line)
        again = "rematted_computation" in line
        if seen:
            shapes[seen.group(1)] = seen.group(2)
            ml, mc = JR._DOT_OPERAND_RE.search(line), JR._CONTRACT_RE.search(
                line)
            if seen.group(3) == "dot" and ml and mc:
                lhs = JR._dims(shapes.get(ml.group(1), ""))
                c = math.prod(lhs[int(i)] for i in mc.group(1).split(",")
                              if i and int(i) < len(lhs))
                f = n * 2 * math.prod(JR._dims(seen.group(2))) * c
                remat += f if again else 0
                outer += f if (not again and "transpose" in line and any(
                    e in line for e in OUTER)) else 0
        m = coll.match(line)
        if m and n:
            groups = re.search(r"replica_groups=\[(\d+),(\d+)\]", line) \
                or re.search(r"replica_groups=\{\{([\d,]*)\}", line)
            size = (int(groups.group(2)) if groups.lastindex == 2 else
                    len(groups.group(1).split(","))) if groups else 0
            parts = [[dt, math.prod(int(d) for d in dims.split(",") if d)]
                     for dt, dims in JR._SHAPE_RE.findall(m.group(1))]
            items.append([n, m.group(2), parts, size, bool(seen), again])
    return {"items": items, "remat_flops": int(remat),
            "outer_flops": int(outer)}


cases = json.loads(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {"cases": {}, "policy": {}}
for name, arch, step, mode, b, s, enc in cases:
    cfg = JCFG.get_smoke(arch)
    tmpl = JZ.templates(cfg)
    p_shard = SHD.param_shardings(tmpl, mesh, mode)
    ps = JMB.shape_structs(tmpl, cfg.dtype)
    i32 = lambda shape: jax.ShapeDtypeStruct(shape, jnp.int32)
    batch = {"tokens": i32((b, 1 if step == "decode" else s))}
    if cfg.arch_type == "encdec" and step != "decode":
        batch["frontend"] = jax.ShapeDtypeStruct((b, enc, cfg.d_model),
                                                 cfg.dtype)
    if step == "train":
        batch["targets"] = i32((b, s))
    b_shard = SHD.batch_shardings(batch, mesh)
    cache = JE.cache_shapes(cfg, b, s, enc)
    c_shard = SHD.cache_shardings(cache, mesh)
    if step == "train":
        opt = adam(1e-4)
        o = {"step": jax.ShapeDtypeStruct((), jnp.int32), "m": ps, "v": ps}
        o_shard = {"step": SHD.replicated(mesh), "m": p_shard, "v": p_shard}
        fn = jax.jit(lambda p, o_, b_: JZ.train_step(p, o_, b_, cfg,
                                                     opt.update),
                     in_shardings=(p_shard, o_shard, b_shard),
                     keep_unused=True)
        args = (ps, o, batch)
    elif step == "prefill":
        fn = jax.jit(lambda p, b_, c: JE.prefill(p, cfg, b_, c),
                     in_shardings=(p_shard, b_shard, c_shard),
                     keep_unused=True)
        args = (ps, batch, cache)
    else:
        fn = jax.jit(lambda p, t, c, n: JE.decode_step(p, cfg, t, c, n),
                     in_shardings=(p_shard, b_shard["tokens"], c_shard,
                                   SHD.replicated(mesh)), keep_unused=True)
        args = (ps, batch["tokens"], cache, i32(()))
    with mesh:
        compiled = fn.lower(*args).compile()
    text = compiled.as_text()
    cost = JR.HloCost(text)
    out["cases"][name] = {
        "arg": int(compiled.memory_analysis().argument_size_in_bytes),
        "flops": int(cost.flops()), "coll": cost.collectives(),
        **itemized(text, cost)}
for arch in JCFG.all_archs():
    cfg = JCFG.get(arch)
    for shape, sh in JSH.SHAPES.items():
        v = JD.recommended_variant(cfg, shape)
        out["policy"][f"{arch}/{shape}"] = [
            v, JD._shard_mode(cfg, sh.step, v),
            JD._shard_mode(cfg, sh.step, "zero3")]
print(json.dumps(out))
"""

# (name, arch, step, mode, batch, seq, frames): the reference's 2 x 2 steps
REF_ARCHS = ("yi-34b", "dbrx-132b", "gemma3-27b", "zamba2-1.2b",
             "rwkv6-1.6b", "seamless-m4t-large-v2")
REF_CASES = [(f"{arch}/{step}/{mode}", arch, step, mode, 4, 16,
              ENC if arch.startswith("seamless") else 0)
             for arch in REF_ARCHS
             for step, modes in (("prefill", ("tp",)), ("decode", ("tp",)),
                                 ("train", ("tp", "fsdp", "zero3")
                                  if arch in ("yi-34b", "dbrx-132b")
                                  else ("tp",)))
             for mode in modes]
# every prefill and decode, and every "tp" training step
FLOP_CASES = [c for c in REF_CASES if c[3] == "tp"]
# the collectives held to the reference's compiled record: the dense and
# encdec families under "tp", and the moe family's serving steps (not its
# training, nor the recurrent families': there the reference's
# partitioner reshards where the port's layout moves nothing, ROADMAP
# item 31)
COLL_CASES = [c for c in REF_CASES if c[3] == "tp" and c[1] in (
    "yi-34b", "gemma3-27b", "seamless-m4t-large-v2")]
MOE_COLL_CASES = [c for c in REF_CASES if c[1] == "dbrx-132b"
                  and c[2] != "train"]


@pytest.fixture(scope="module", autouse=True)
def _reference_run():
    """The reference's subprocess, started before this file's first test
    so that its compiles (~50 s) run beside the ranks and the traces."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                                 json.dumps(REF_CASES)], env=env,
                                stdout=subprocess.PIPE, stderr=err,
                                text=True)
        try:
            yield proc, err
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture(scope="module")
def reference(_reference_run):
    proc, err = _reference_run
    out, _ = proc.communicate(timeout=600)
    err.seek(0)
    assert proc.returncode == 0, err.read()[-3000:]
    return json.loads(out.splitlines()[-1])


def _rank_record(case, rank=0):
    _, arch, step, mode, b, s, enc = case
    cfg = TCFG.get_smoke(arch)
    mesh = train_mesh(2, 2)
    layout = (TPAR.TrainLayout(mode, SH.param_layouts(Z.templates(cfg),
                                                      mesh, mode))
              if step == "train" else None)
    return cfg, D.rank_record(cfg, step, TPAR.ModelParallel.counting(
        mesh, rank), batch=b, seq_len=s, layout=layout, enc_len=enc)


def _rank_log(cfg, case, mp) -> list:
    """The counting transport's log of rank `mp`'s step of a case."""
    _, _, step, mode, b, s, enc = case
    layout = (TPAR.TrainLayout(mode, SH.param_layouts(Z.templates(cfg),
                                                      mp.mesh, mode))
              if step == "train" else None)
    D.rank_record(cfg, step, mp, batch=b, seq_len=s, layout=layout,
                  enc_len=enc)
    return list(mp.log)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def held_otherwise(cfg, step, mode, b, s, enc, rank=0) -> int:
    """The bytes a rank of the 2 x 2 mesh holds beyond the reference's
    block of each leaf it holds otherwise: parameters where
    `rank_pieces` differs from the layout's block (`local_slices`; three
    trees at train: params, m, v), and at prefill / decode the cache
    leaves the port lays out otherwise than the reference's
    `cache_layouts` (Mamba2's conv state: B / C whole; RWKV-6's shift
    states whole)."""
    mesh = train_mesh(2, 2)
    tmpl = Z.templates(cfg)
    specs = SH.param_layouts(tmpl, mesh, mode)
    pieces = TPAR.rank_pieces(tmpl, specs, mesh, rank)
    extra = 0
    for t, spec, held in zip(MB.tree_leaves(tmpl), MB.tree_leaves(specs),
                             MB.tree_leaves(pieces)):
        mine = math.prod(sum(m for _, m in dim) for dim in held)
        block = math.prod(m for _, m in TPAR.local_slices(t.shape, spec,
                                                          mesh, rank))
        extra += (mine - block) * cfg.dtype.itemsize
    if step == "train":
        return 3 * extra
    mp = TPAR.ModelParallel.counting(mesh, rank)
    rows = b // 2
    frames = enc or (s if step == "prefill" else 0)
    glob = E.cache_shapes(cfg, b, s, frames)
    lay = SH.cache_layouts(glob, mesh)
    for k, (shape, dt) in E.local_cache_shapes(cfg, rows, s, mp,
                                               frames).items():
        ref = [m for _, m in TPAR.local_slices(glob[k][0], lay[k], mesh,
                                               rank)]
        extra += _nbytes(shape, dt) - _nbytes(ref, dt)
    return extra


@pytest.mark.parametrize("case", REF_CASES, ids=[c[0] for c in REF_CASES])
def test_argument_bytes_equal_the_reference(case, reference):
    """A rank's argument bytes (its storages: params, m and v at train,
    its rows of the batch, its part of the cache) equal the reference's
    per-device `argument_size_in_bytes`, less the leaves it holds
    otherwise (`held_otherwise`, named there) and the decode's 4-byte
    cache_len."""
    _, arch, step, mode, b, s, enc = case
    cfg, rec = _rank_record(case)
    want = reference["cases"][case[0]]["arg"]
    extra = held_otherwise(cfg, step, mode, b, s, enc)
    if cfg.arch_type not in ("ssm", "hybrid"):
        assert extra == 0, extra
    cache_len = 4 if step == "decode" else 0
    assert rec["memory"]["argument_size_in_bytes"] == want - cache_len \
        + extra


def _rank_tokens(case) -> int:
    _, _, step, _, b, s, _ = case
    return b // 2 * (1 if step == "decode" else s)


def _held_beyond_block(cfg, leaves) -> int:
    """The elements of rank 0's pieces of cfg's Mamba2 `leaves` beyond
    their "tp" blocks on the 2 x 2 mesh (`rank_pieces` against
    `local_slices`)."""
    mesh = train_mesh(2, 2)
    tmpl = Z.templates(cfg)
    specs = SH.param_layouts(tmpl, mesh, "tp")
    mixer = (tmpl["blocks"]["mixer"], specs["blocks"]["mixer"],
             TPAR.rank_pieces(tmpl, specs, mesh, 0)["blocks"]["mixer"])
    extra = 0
    for k in leaves:
        t, spec, held = (m[k] for m in mixer)
        extra += (math.prod(sum(n for _, n in dim) for dim in held)
                  - math.prod(n for _, n in TPAR.local_slices(
                      t.shape, spec, mesh, 0)))
    return extra


def flop_differences(cfg, case, ref, port_outer: int) -> dict:
    """The reference's dot FLOPs less rank 0's, by named cause, for a case
    of the 2 x 2 mesh under "tp" (T its rows x positions). Both sides
    remat the same blocks (the reference's dots under
    `rematted_computation`, the port's recompute), so a train step runs
    each forward difference four times (forward, its recompute, and the
    two products of each in the backward), but where one of those is an
    outer product:

      * outer (train): a product with no summed index is a multiply in
        XLA: the port's backward matmuls with a contraction of one
        (`port_outer`) count in the port, XLA's transposes of the
        reference's outer-product einsums (rwkv6's k v^T, mamba2's
        dt x B^T) in the reference;
      * moe_capacity: the reference's GSPMD partition of `moe_ffn` runs
        each of the rank's experts over the whole batch's capacity C =
        ceil(cf T_batch k / E) on every data rank, the port over the
        min(C, T k) rows its own tokens can fill (`_dispatch_rows`): three
        expert matmuls;
      * mamba2_bc (negative): the port's rank holds Mamba2's B / C columns
        of in_proj and their conv channels whole (`parallel.mamba_pieces`),
        2 T FLOPs for each element held beyond the reference's block (in
        training, the conv's input gradient is an outer product: the
        conv's forward, its recompute and its weight's gradient);
      * rwkv6_lora (negative): the reference contracts each LoRA's d over
        the model axis (its input arrives cut), the port's rank runs the
        whole d (its x is whole): 11 of a layer's 12 LoRA dots (the decay
        LoRA's up-projection is cut to the rank's channels in both)."""
    _, _, step, _, b, s, _ = case
    t, world, out = _rank_tokens(case), 2, {}
    train = step == "train"
    if train:
        out["outer"] = ref["outer_flops"] - port_outer
    if cfg.arch_type == "moe":
        t_batch = b * (1 if step == "decode" else s)
        cap = math.ceil(cfg.capacity_factor * t_batch * cfg.top_k
                        / cfg.n_experts)
        rows = min(cap, t * cfg.top_k)
        per = (2 * cfg.n_experts // world * (cap - rows) * cfg.d_model
               * cfg.d_ff)
        out["moe_capacity"] = (4 if train else 1) * 3 * cfg.n_layers * per
    if cfg.arch_type == "hybrid":
        out["mamba2_bc"] = -2 * t * (
            (4 if train else 1) * _held_beyond_block(cfg, ("in_proj",))
            + (3 if train else 1) * _held_beyond_block(cfg, ("conv_w",)))
    if cfg.arch_type == "ssm":
        out["rwkv6_lora"] = -((4 if train else 1) * cfg.n_layers * 11 * 2 * t
                              * cfg.rwkv_lora_dim
                              * (cfg.d_model - cfg.d_model // world))
    return out


@pytest.mark.parametrize("case", FLOP_CASES, ids=[c[0] for c in FLOP_CASES])
def test_dot_flops_equal_the_reference(case, reference):
    """Rank 0's FLOPs (matmuls, and K8's own at decode) equal the dot
    FLOPs of the reference's compiled 2 x 2 step, but for the differences
    `flop_differences` names, each to the FLOP (none for the dense and
    encdec families' prefill and decode; no remat difference in training:
    the port's recompute is the reference's, dot for dot). A train step's
    port count is taken under `OuterProducts` too."""
    with OuterProducts() as outer:
        cfg, rec = _rank_record(case)
    ref = reference["cases"][case[0]]
    diff = flop_differences(cfg, case, ref, outer.flops)
    if case[2] != "train" and cfg.arch_type in ("dense", "encdec"):
        assert diff == {}
    if case[2] == "train":
        assert ref["remat_flops"] > 0 and "remat" not in diff
        assert (diff["outer"] != 0) == (cfg.arch_type in ("ssm", "hybrid"))
    assert int(rec["dot_flops_per_device"]) + sum(diff.values()) == \
        ref["flops"], diff


def _elements(items, kind, *, seen=None, again=None) -> int:
    """The result elements of the reference's collectives of `kind`
    (times their trips), of those HloCost parsed (seen) or not, under a
    rematerialized computation (again) or not."""
    return sum(n * sum(e for _, e in parts)
               for n, k, parts, _, s, a in items
               if k == kind and seen in (None, s) and again in (None, a))


def _stacked_elements(cfg, mode="tp") -> int:
    """The elements of rank 0's pieces of the layer stacks' leaves."""
    mesh = train_mesh(2, 2)
    tmpl = Z.templates(cfg)
    pieces = TPAR.rank_pieces(tmpl, SH.param_layouts(tmpl, mesh, mode),
                              mesh, 0)
    return sum(math.prod(sum(n for _, n in dim) for dim in held)
               for key in ("blocks", "enc_blocks") if key in pieces
               for held in MB.tree_leaves(pieces[key]))


@pytest.mark.parametrize("case", COLL_CASES, ids=[c[0] for c in COLL_CASES])
def test_collectives_equal_the_reference(case, reference, monkeypatch):
    """Rank 0's collectives, in the reference's terms (result elements by
    kind), equal the collectives of the reference's compiled 2 x 2 step
    (`HloCost(...).collectives()`, and each collective of its HLO with its
    trips), but for these differences, each asserted to the element:

      * the host compile runs every all-reduce in float32 (its float
        normalization promotes bfloat16's): the record's bytes are 4 a
        result element; elements are compared;
      * the port gathers the vocab-cut logits onto every rank (prefill and
        decode: the last position's; train: every position's, for the
        loss), where the reference's step returns them cut and its loss
        all-reduces each position's max, sum and target logit instead;
      * train: the reference all-reduces the input gradient of each projection that reads
        one input apart (q, k, v; gate and up of a SwiGLU FFN; an encdec
        decoder's cross k and v), where the port sums them first;
      * train: HloCost misses the all-reduce of the layer stacks' weight
        gradients over "data": its tuple of six or more results prints
        `/*index=5*/`, which the parser's result pattern refuses.

    Both remat the same blocks: the reference's checkpointed layers
    re-issue each attention output's all-reduce (self, and cross for
    encdec) in the backward, and so does the port's recompute (with the
    test seam `zoo._REMAT` off its step issues exactly those fewer; the
    MLP's sum follows the last tensor its backward reads, and neither
    re-issues it). Prefill and decode issue the same all-reduces: their
    counts are equal too. Train counts differ as XLA combines
    all-reduces; bytes do not."""
    _, arch, step, mode, b, s, enc = case
    cfg, rec = _rank_record(case)
    ref = reference["cases"][case[0]]
    items, coll = ref["items"], ref["coll"]
    assert {k for _, k, *_ in items} == {"all-reduce"}
    assert {dt for _, _, parts, *_ in items for dt, _ in parts} == {"f32"}
    assert coll["all-reduce_bytes"] == 4 * _elements(items, "all-reduce",
                                                     seen=True)
    mp = TPAR.ModelParallel.counting(train_mesh(2, 2), 0)
    log = _rank_log(cfg, case, mp)
    port = _port_elements(log)
    assert port["all_reduce_max"] == port["reduce_scatter"] == 0
    rows, d = b // 2, cfg.d_model
    t = _rank_tokens(case)
    frames = rows * enc
    assert port["all_gather"] == (t if step == "train" else rows) * cfg.vocab
    differences = {}
    if step == "train":
        attn_out = cfg.n_layers * (2 if enc else 1) * t + \
            cfg.n_enc_layers * frames
        split = (2 + (cfg.mlp_act == "swiglu"))
        differences = {
            "loss": 3 * t,
            "split": split * (cfg.n_layers * t + cfg.n_enc_layers * frames)
            * d + (cfg.n_layers * frames * d if enc else 0),
            "parser": -_elements(items, "all-reduce", seen=False)}
        assert _elements(items, "all-reduce", again=True) == attn_out * d
        assert -differences["parser"] == _stacked_elements(cfg)
        monkeypatch.setattr(Z, "_REMAT", False)
        once = _port_elements(_rank_log(
            cfg, case, TPAR.ModelParallel.counting(train_mesh(2, 2), 0)))
        assert port["all_reduce_sum"] - once["all_reduce_sum"] == \
            attn_out * d
    else:
        assert coll["all-reduce_count"] == sum(
            1 for kind, *_ in log if kind == "all_reduce_sum")
    assert coll["all-reduce_bytes"] == 4 * (port["all_reduce_sum"]
                                            + sum(differences.values()))
    assert coll["total_bytes"] == coll["all-reduce_bytes"]


def _port_elements(log) -> dict:
    """The result elements of a rank's collectives by kind, from its
    counting transport's log."""
    return {k: sum(n // size * (len(m) if k == "all_gather" else 1)
                   for kind, n, m, size in log if kind == k)
            for k in ("all_reduce_sum", "all_reduce_max", "all_gather",
                      "reduce_scatter")}


@pytest.mark.parametrize("case", MOE_COLL_CASES,
                         ids=[c[0] for c in MOE_COLL_CASES])
def test_moe_serving_collectives_equal_the_reference(case, reference):
    """dbrx-smoke's prefill and decode over 2 x 2 (T_b the batch's tokens,
    T this data rank's, k choices, E experts, L layers): both all-reduce
    the embedded rows and each attention output over the model axis. The
    rest is each side's own dispatch, each term asserted to the element
    (every result 4 bytes: f32 or s32, the all-reduces promoted as above):

      * the port (`moe_ffn_shmap`: every model rank routes its data rank's
        tokens and runs its experts) all-reduces each layer's expert
        output (T x d) over "model" and its per-expert counts and router
        sums (2 E + 2 E f32) over "data", and gathers the last position's
        logits;
      * the reference's GSPMD partition of `moe_ffn` all-gathers over
        "data" each layer's routing for the whole batch (its router
        probabilities T_b x E, one-hot choices T_b k x E, slot indices
        T_b k x 2, chosen rows T_b k x d), moves the rank's rows once (a
        collective-permute, T x d) and all-reduces the combined output
        (T_b x d) twice over the whole mesh."""
    _, arch, step, mode, b, s, enc = case
    cfg, rec = _rank_record(case)
    ref = reference["cases"][case[0]]
    coll = ref["coll"]
    mp = TPAR.ModelParallel.counting(train_mesh(2, 2), 0)
    port = _port_elements(_rank_log(cfg, case, mp))
    t, d, e, k, n = (_rank_tokens(case), cfg.d_model, cfg.n_experts,
                     cfg.top_k, cfg.n_layers)
    t_b = 2 * t
    assert port["all_gather"] == b // 2 * cfg.vocab
    assert port["all_reduce_sum"] == t * d + n * (2 * t * d + 4 * e)
    shared = t * d + n * t * d
    assert coll["all-reduce_bytes"] == 4 * (shared + n * 2 * t_b * d)
    assert coll["all-reduce_count"] == 1 + 3 * n
    assert coll["all-gather_bytes"] == 4 * n * (t_b * e + t_b * k * (e + 2
                                                                    + d))
    assert coll["all-gather_count"] == 4 * n
    assert coll["collective-permute_bytes"] == 4 * n * t * d
    assert coll["collective-permute_count"] == n
    assert coll["total_bytes"] == sum(coll[f"{kind}_bytes"] for kind in (
        "all-reduce", "all-gather", "collective-permute"))


def test_variant_and_shard_mode_equal_the_reference(reference):
    """`pod_variant` and `shard_mode` (with the variant, and with "zero3")
    pick what the reference's `recommended_variant` and `_shard_mode` pick
    for every arch x shape."""
    got = {}
    for arch in TCFG.all_archs():
        cfg = TCFG.get(arch)
        for shape, sh in TSH.SHAPES.items():
            v = D.pod_variant(cfg, shape)
            got[f"{arch}/{shape}"] = [v, D.shard_mode(cfg, sh.step, v),
                                      D.shard_mode(cfg, sh.step, "zero3")]
    assert got == reference["policy"]
    assert {v for v, *_ in got.values()} == {"seqkv", "shmap", "chunked",
                                             "baseline"}
    assert {m for _, m, _ in got.values()} == {"tp", "fsdp"}


# -- the pieces, the transport, the conversions --------------------------------

@pytest.mark.parametrize("mode", ["tp", "fsdp", "zero3"])
def test_folded_mesh_gives_the_same_pieces(mode):
    """The 512-chip mesh (pod 2, data 16, model 16) and its fold (data 32,
    model 16) give every rank the same pieces of every leaf, for every
    arch (ranks 0..511 on the smoke templates; the published templates'
    dims are the ones the rules cut, checked at a stride of ranks)."""
    pod, folded = production_mesh(multi_pod=True), D.fold_mesh(
        production_mesh(multi_pod=True))
    assert folded.axis_names == ("data", "model") and folded.sizes == (32, 16)
    for arch in TCFG.all_archs():
        for cfg, ranks in ((TCFG.get_smoke(arch), range(512)),
                           (TCFG.get(arch), range(0, 512, 37))):
            tmpl = Z.templates(cfg)
            a = SH.param_layouts(tmpl, pod, mode)
            b = SH.param_layouts(tmpl, folded, mode)
            for r in ranks:
                assert TPAR.rank_pieces(tmpl, a, pod, r) == \
                    TPAR.rank_pieces(tmpl, b, folded, r), (arch, r)


def test_counting_transport_refuses_real_tensors():
    """The counting transport counts and moves nothing, on `meta` only."""
    mp = TPAR.ModelParallel.counting(train_mesh(2, 2), 3)
    assert (mp.rank, mp.data_rank, mp.world, mp.data_world) == (1, 1, 2, 2)
    assert mp.backend == "meta" and mp.device.type == "meta"
    x = torch.empty((2, 3), device="meta")
    assert mp.all_reduce_sum(x) is x
    assert mp.gather_axes(x, 0, ("data", "model")).shape == (8, 3)
    assert mp.reduce_scatter_axes(torch.empty((4, 3), device="meta"), 0,
                                  ("data",)).shape == (2, 3)
    assert mp.calls == {"all_reduce_sum": 1, "all_gather": 1,
                        "reduce_scatter": 1}
    assert mp.bytes == {"all_reduce_sum": 24, "all_gather": 24,
                        "reduce_scatter": 48}
    assert mp.log == [("all_reduce_sum", 24, (2, 3), 4),
                      ("all_gather", 24, (0, 1, 2, 3), 4),
                      ("reduce_scatter", 48, (1, 3), 4)]
    for fn in (mp.all_reduce_sum, mp.all_reduce_max,
               lambda t: mp.gather_axes(t, 0, ("model",))):
        with pytest.raises(ValueError, match="counting transport"):
            fn(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="mesh"):
        TPAR.ModelParallel.counting(production_mesh(multi_pod=True), 0)


def test_result_bytes_and_links():
    """The reference counts a collective's result bytes, the transport
    the bytes a rank puts in: an all-gather's result is n shards, a
    reduce-scatter's one of its n blocks, an all-reduce's its input. A
    group within one 8-GPU NVLink domain is priced at NVLink's rate, a
    wider one at InfiniBand's."""
    assert RL.result_bytes("all_gather", 24, 4) == 96
    assert RL.result_bytes("reduce_scatter", 48, 2) == 24
    assert RL.result_bytes("all_reduce_sum", 24, 16) == 24
    assert RL.result_bytes("all_reduce_max", 8, 16) == 8
    with pytest.raises(ValueError):
        RL.result_bytes("all_to_all", 8, 2)
    assert RL.link(range(8)) == "nvlink" and RL.link(range(8, 16)) == \
        "nvlink"
    assert RL.link(range(16)) == "ib" and RL.link((0, 16)) == "ib"
    coll = RL.collectives([("all_gather", 24, (0, 1, 2, 3), 4),
                           ("all_reduce_sum", 100, tuple(range(16)), 2)])
    assert coll == {"total_bytes": 196, "nvlink_bytes": 96,
                    "ib_bytes": 100, "all_gather_bytes": 96,
                    "all_gather_count": 1, "all_reduce_sum_bytes": 100,
                    "all_reduce_sum_count": 1}
    assert RL.collective_s(coll) == 96 / RL.NVLINK_BW + 100 / RL.IB_BW
    rec = {"cost": {"flops": 0.0, "bytes accessed": 0.0},
           "dtype": "bfloat16", "collectives": coll}
    assert RL.bound(rec) == (RL.collective_s(coll), "collective")
    assert "t_collective_s" in RL.terms(rec)
    assert "t_collective_s" not in RL.terms({"cost": rec["cost"]})


def test_empty_partial_range_reports_no_call():
    """K8's partials on `meta`: a range of slots reports its call and
    work; an empty range none (the card launches nothing for it)."""
    seen = []
    q = torch.empty((2, 4, 64), device="meta")
    k = torch.empty((2, 8, 2, 64), device="meta")
    with ops.kernel_work_sink(lambda *a: seen.append(a[:2])):
        ops.swa_decode_partial(q, k, k, 2, 5)
        ops.swa_decode_partial(q, k, k, 5, 5)
    assert seen == [("swa_decode_partial", 4 * 2 * 4 * 3 * 64)]


# -- the CLI and the example ---------------------------------------------------

def test_cli_writes_a_pod_record(tmp_path, capsys):
    """`--pod` writes {arch}__{shape}__pod1[__variant].json with the
    reference's keys, a collective term, and the port's own."""
    D.main(["--pod", "--arch", "zamba2-1.2b", "--shape", "decode_32k",
            "--variant", "auto", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "zamba2-1.2b__decode_32k__pod1__seqkv.json")
                     .read_text())
    for key in ("n_chips", "multi_pod", "shard_mode", "variant", "memory",
                "cost", "dot_flops_per_device", "bytes_per_device",
                "collectives", "roofline", "kernel_calls", "fits_one_card",
                "trace_s", "classes"):
        assert key in rec, key
    assert (rec["n_chips"], rec["multi_pod"], rec["shard_mode"]) == (
        256, False, "tp")
    assert set(rec["roofline"]) >= {"t_compute_s", "t_memory_s",
                                    "t_collective_s", "dominant"}
    assert rec["collectives"]["total_bytes"] == rec["collectives"]["ib_bytes"]
    assert rec["kernel_calls"] == {"swa_decode_partial": 6}
    assert "1 failed" not in capsys.readouterr().out
    with pytest.raises(SystemExit):
        D.main(["--multi-pod", "--arch", "yi-34b"])


@pytest.mark.parametrize("param_dtype", [None, torch.float32])
def test_record_prices_the_dtype_its_matmuls_run_in(param_dtype):
    """A step whose weights are float32 computes in float32 (its embedded
    rows are float32): its record's dtype, and so its compute term and its
    bound, are float32's, whatever cfg.dtype says; with no param_dtype,
    cfg.dtype's. The one-card record (no ModelParallel) is the same trace
    with no collectives."""
    cfg, mesh = R.smoke_cfg("yi-34b"), train_mesh(2, 2)
    layout = TPAR.TrainLayout("tp", SH.param_layouts(Z.templates(cfg), mesh,
                                                     "tp"))
    rec = D.rank_record(cfg, "train", TPAR.ModelParallel.counting(mesh, 0),
                        batch=4, seq_len=S, layout=layout,
                        param_dtype=param_dtype)
    dtype = param_dtype or cfg.dtype
    assert rec["dtype"] == str(dtype).removeprefix("torch.")
    assert RL.terms(rec)["t_compute_s"] == \
        rec["cost"]["flops"] / RL.PEAK_FLOPS_BY_DTYPE[dtype]
    one = D.rank_record(cfg, "train", batch=4, seq_len=S,
                        param_dtype=param_dtype)
    assert "collectives" not in one and "calls" not in one
    assert one["dtype"] == rec["dtype"]
    assert one["memory"]["argument_size_in_bytes"] == \
        3 * cfg.param_count() * dtype.itemsize + 4 + 2 * 4 * S * 4


def test_pod_record_skips_zero3_serving_and_long_context():
    """A combo the reference's `shapes.applicable` rules out is skipped
    under every variant, "zero3" included, with its reason; zero3 serving
    itself is traced since it runs (tests/test_torch_zero3_serve.py)."""
    for variant in ("zero3", "baseline"):
        rec = D.pod_record("yi-34b", "long_500k", variant=variant)
        assert rec["status"] == "skipped", variant
        assert rec["skipped"] == TSH.applicable(TCFG.get("yi-34b"),
                                                "long_500k")[1]
        assert "item 30" not in rec["skipped"]


def test_multi_pod_example_runs():
    """`examples/multi_pod_dryrun.py` prints one combo's record without
    `memory` on the 512-chip mesh."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.multi_pod_dryrun",
         "--arch", "zamba2-1.2b", "--shape", "decode_32k"], env=env,
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads(proc.stdout)
    assert rec["n_chips"] == 512 and rec["multi_pod"] and "memory" not in rec
