"""The port's dry-run cost report (`repro_torch.launch.dryrun`, `roofline`)
on the CPU against the reference's compiled HLO.

The port traces a step on `meta` tensors and counts its matmul FLOPs with
`FlopCounterMode` (K8 adds its own); the reference's dry run lowers the
jitted step and counts its dot FLOPs with `roofline.HloCost`. At the
smoke configs (B = 2, S = 64) the two counts are equal exactly for every
family's forward, prefill and decode, with one exception asserted to the
FLOP and named: zamba2's chunked forward, where XLA drops a product whose
result is dead (see `test_zamba2_chunked_forward_dead_state_product`).
Train: the port has no remat, so its step is exactly three forwards; the
reference's HLO adds its `jax.checkpoint` recompute, exactly, once each
side's outer products are counted as the other's compiler runs them.
The decode step's bytes are held to `chip_smoke.py`'s hand formulas plus
the terms they leave out, each added here by name.
"""

import collections
import dataclasses
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as JCFG
import repro_torch.configs as TCFG
from repro.launch import roofline as JR
from repro.models import base as JMB
from repro.models import zoo as JZ
from repro.optim import adam as jadam
from repro.serving import engine as JE
from repro_torch.configs import shapes as SH
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as TR
from repro_torch.models import base as TMB
from repro_torch.models import zoo as TZ
from repro_torch.optim import adam as tadam

REPO = Path(__file__).resolve().parents[1]
B, S = 2, 64
ENC = 16                  # an encdec model's frontend frames here
# one case per family (and per form of the recurrent ones)
CASES = [("starcoder2-3b", "scan"), ("gemma3-27b", "scan"),
         ("dbrx-132b", "scan"), ("rwkv6-1.6b", "scan"),
         ("rwkv6-1.6b", "chunked"), ("zamba2-1.2b", "scan"),
         ("zamba2-1.2b", "chunked"), ("seamless-m4t-large-v2", "scan")]


def configs(arch, impl="scan"):
    return (dataclasses.replace(JCFG.get_smoke(arch), ssm_impl=impl),
            dataclasses.replace(TCFG.get_smoke(arch), ssm_impl=impl))


def enc_len(cfg) -> int:
    return ENC if cfg.arch_type == "encdec" else 0


def ref_flops(cfg, step, s=S) -> int:
    """The reference's dot FLOPs of its jitted step (HloCost of the
    compiled HLO, as its dry run counts them)."""
    ps = JMB.shape_structs(JZ.templates(cfg), cfg.dtype)
    i32 = lambda shape: jax.ShapeDtypeStruct(shape, jnp.int32)
    batch = {"tokens": i32((B, s))}
    if cfg.arch_type == "encdec":
        batch["frontend"] = jax.ShapeDtypeStruct((B, ENC, cfg.d_model),
                                                 cfg.dtype)
    if step == "forward":
        low = jax.jit(lambda p, b: JZ.forward(p, cfg, b)).lower(ps, batch)
    elif step == "train":
        batch["targets"] = i32((B, s))
        opt = jadam(1e-4)
        o = {"step": jax.ShapeDtypeStruct((), jnp.int32), "m": ps, "v": ps}
        low = jax.jit(lambda p, o_, b: JZ.train_step(
            p, o_, b, cfg, opt.update)).lower(ps, o, batch)
    elif step == "prefill":
        cache = JE.cache_shapes(cfg, B, s, ENC)
        low = jax.jit(lambda p, b, c: JE.prefill(p, cfg, b, c)).lower(
            ps, batch, cache)
    else:
        cache = JE.cache_shapes(cfg, B, s, ENC)
        low = jax.jit(lambda p, t, c, n: JE.decode_step(p, cfg, t, c, n)
                      ).lower(ps, i32((B, 1)), cache, i32(()))
    return int(JR.HloCost(low.compile().as_text()).flops())


def port_forward_flops(cfg, s=S) -> int:
    params = TMB.shape_structs(TZ.templates(cfg), cfg.dtype)
    batch = {k: D._meta(v) for k, v in SH.step_batch_specs(
        cfg, "prefill", B, s, enc_len(cfg)).items()}
    with FlopCounterMode(display=False) as fc:
        TZ.forward(params, cfg, batch)
    return fc.get_total_flops()


def port_flops(cfg, step) -> int:
    if step == "forward":
        return port_forward_flops(cfg)
    rec = D.step_record(cfg, step, batch=B, seq_len=S, enc_len=enc_len(cfg))
    return int(rec["cost"]["flops"])


# -- FLOPs against the reference's HLO ----------------------------------------

@pytest.mark.parametrize("step", ["forward", "prefill", "decode"])
@pytest.mark.parametrize("arch,impl", CASES, ids=lambda v: str(v))
def test_flops_equal_reference_hlo(arch, impl, step):
    """Decode at cache_len = S - 1, where K8's n_valid positions are the S
    slots the reference's decode attention computes over (a gemma3 ring:
    its W slots, once the ring is full)."""
    jcfg, tcfg = configs(arch, impl)
    want = ref_flops(jcfg, step)
    got = port_flops(tcfg, step)
    if (arch, impl, step) == ("zamba2-1.2b", "chunked", "forward"):
        got -= dead_state_product(tcfg)
    assert got == want


def dead_state_product(cfg) -> int:
    """The FLOPs of mamba2_chunked's chunk-state product S_in =
    einsum("bih,bin,bihp->bhpn") of one chunk, in every layer: 2 B nh
    hdim N chunk."""
    return (2 * B * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 128
            * cfg.n_layers)


def test_zamba2_chunked_forward_dead_state_product():
    """At S = 64 the chunked form runs one chunk of 128. The forward
    discards the final SSM state, and the only consumer of the last
    chunk's S_in product is that state: XLA inlines the one-trip scan and
    drops the dead dot, while the port (eager) computes it, 8,388,608
    FLOPs at the smoke config. The prefill keeps the state, so there the
    counts are equal (test above); at S = 256 (two chunks, a while loop XLA
    keeps whole) the forwards are equal too. The port does no work the
    reference's program does not specify: not a fault."""
    jcfg, tcfg = configs("zamba2-1.2b", "chunked")
    assert dead_state_product(tcfg) == 8_388_608
    assert (port_forward_flops(tcfg) - ref_flops(jcfg, "forward")
            == dead_state_product(tcfg))
    assert port_forward_flops(tcfg, s=256) == ref_flops(jcfg, "forward",
                                                        s=256)


# -- train ----------------------------------------------------------------------

def last_products(cfg) -> int:
    """The FLOPs of each checkpointed block's last product, whose result
    only joins the residual: the reference's remat does not recompute it.
    Dense: the MLP's down projection; encdec: the decoder's cross-attention
    out projection and the encoder's MLP down projection; hybrid: the
    shared block's MLP down projection, once per application (its
    checkpoint wraps a group of mamba layers and the shared block); moe and
    ssm: none (the experts' outputs feed the gate's gradient, the
    channel mix's both factors each other's)."""
    t = B * S
    if cfg.arch_type == "dense":
        return cfg.n_layers * 2 * t * cfg.d_ff * cfg.d_model
    if cfg.arch_type == "hybrid":
        return TZ.shared_applications(cfg) * 2 * t * cfg.d_ff * cfg.d_model
    if cfg.arch_type == "encdec":
        h = cfg.n_heads * cfg.hd
        return (cfg.n_layers * 2 * t * h * cfg.d_model
                + cfg.n_enc_layers * 2 * B * ENC * cfg.d_ff * cfg.d_model)
    return 0


class OuterProducts(TorchDispatchMode):
    """The FLOPs of matmuls with a contraction of one (an outer product:
    torch's einsum runs a product with no summed index as such a bmm,
    which FlopCounterMode counts and XLA turns into a multiply)."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            if args[0].shape[-1] == 1:
                self.flops += 2 * out.numel()
        return out


def port_outer_products(cfg) -> int:
    args = D.step_inputs(cfg, "train", batch=B, seq_len=S,
                         enc_len=enc_len(cfg))
    with OuterProducts() as op:
        TZ.train_step(args["params"], args["opt_state"], args["batch"], cfg,
                      tadam(1e-4).update)
    return op.flops


# the reference's einsums of an outer product (no summed index; the port
# writes each as a broadcast multiply): XLA's transposes of them are dots
OUTER_EINSUMS = ("bhk,bhv->bhkv",          # rwkv6_timemix's k v^T
                 "bhp,bn,bh->bhpn")        # mamba2_scan's dt x B^T


def ref_train(cfg) -> tuple[int, int]:
    """The reference's train HLO: (its dot FLOPs, the dot FLOPs of the
    transposes of OUTER_EINSUMS), each dot times its computation's trips
    (the call graph HloCost walks)."""
    ps = JMB.shape_structs(JZ.templates(cfg), cfg.dtype)
    i32 = lambda shape: jax.ShapeDtypeStruct(shape, jnp.int32)
    batch = {"tokens": i32((B, S)), "targets": i32((B, S))}
    if cfg.arch_type == "encdec":
        batch["frontend"] = jax.ShapeDtypeStruct((B, ENC, cfg.d_model),
                                                 cfg.dtype)
    opt = jadam(1e-4)
    o = {"step": jax.ShapeDtypeStruct((), jnp.int32), "m": ps, "v": ps}
    hlo = jax.jit(lambda p, o_, b: JZ.train_step(p, o_, b, cfg, opt.update)
                  ).lower(ps, o, batch).compile().as_text()
    hc = JR.HloCost(hlo)
    trips = collections.Counter()

    def walk(comp, m):
        trips[comp] += m
        for callee, k in hc._calls.get(comp, []):
            walk(callee, m * k)
    walk(hc.entry, 1)
    comp, shapes, outer = None, {}, 0
    for line in hlo.splitlines():
        mdef = JR._COMP_DEF_RE.match(line)
        if mdef and "=" not in line.split("(")[0]:
            comp = mdef.group(2)
            continue
        mop = JR._OP_DEF_RE.match(line)
        if not mop:
            continue
        name, shape, opcode = mop.groups()
        shapes[name] = shape
        op_name = re.search(r'op_name="([^"]*)"', line)
        if (opcode == "dot" and op_name and "transpose" in op_name.group(1)
                and any(f"/{e}/" in op_name.group(1)
                        for e in OUTER_EINSUMS)):
            lhs = JR._dims(shapes[JR._DOT_OPERAND_RE.search(line).group(1)])
            contract = [int(c) for c in JR._CONTRACT_RE.search(line)
                        .group(1).split(",") if c]
            outer += (trips[comp] * 2 * math.prod(JR._dims(shape))
                      * math.prod(lhs[c] for c in contract))
    return int(hc.flops()), outer


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-27b", "dbrx-132b",
                                  "rwkv6-1.6b", "zamba2-1.2b",
                                  "seamless-m4t-large-v2"])
def test_train_is_three_forwards_plus_reference_remat(arch):
    """The port's train step (no remat) counts exactly 3 x its forward (the
    recurrent families in their scan form). The reference's train HLO is
    exactly that plus its `jax.checkpoint` recompute (the forward of every
    checkpointed block, all but the embedding and the head, but its last
    product), with the outer products counted as XLA counts them: less
    the port's backward bmms with a contraction of one (a multiply in
    XLA), plus the dots of XLA's transposes of the reference's
    outer-product einsums (a multiply in the port: rwkv6's k v^T, mamba2's
    dt x B^T)."""
    jcfg, tcfg = configs(arch)
    fwd = port_forward_flops(tcfg)
    train = port_flops(tcfg, "train")
    assert train == 3 * fwd
    head = 2 * B * S * tcfg.d_model * tcfg.vocab
    remat = fwd - head - last_products(tcfg)
    want, outer = ref_train(jcfg)
    assert want == train + remat - port_outer_products(tcfg) + outer
    if arch == "starcoder2-3b":
        assert remat == 184_549_376 and outer == 0
    if tcfg.arch_type in ("ssm", "hybrid"):
        assert outer > 0


# -- roofline -------------------------------------------------------------------

@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "dbrx-132b",
                                  "zamba2-1.2b"])
def test_roofline_work_terms_equal_reference(arch, step):
    """streaming_floor_bytes gives the reference's value on the same record,
    and terms' work terms (model FLOPs, the useful fraction) the
    reference's; the time terms are the card's peaks applied to them."""
    _, tcfg = configs(arch)
    rec = D.step_record(tcfg, step, batch=B, seq_len=S)
    jrec = dict(rec, hlo_dot_flops_per_device=rec["dot_flops_per_device"])
    for n_chips in (1, 256):
        assert (TR.streaming_floor_bytes(rec, n_chips)
                == JR.streaming_floor_bytes(jrec, n_chips))
    got, want = TR.terms(rec, 1), JR.terms(jrec, 1)
    assert got["model_flops"] == want["model_flops"]
    assert got["useful_fraction"] == want["useful_fraction"]
    assert got["flops_global"] == want["hlo_flops_global"]
    assert got["t_compute_s"] == rec["cost"]["flops"] / TR.PEAK_FLOPS
    assert got["t_memory_s"] == rec["bytes_per_device"] / TR.HBM_BW
    assert rec["bytes_per_device"] == max(rec["cost"]["bytes accessed"],
                                          JR.streaming_floor_bytes(jrec, 1))
    bound, by = TR.bound(rec)
    assert bound == max(got["t_compute_s"],
                        rec["cost"]["bytes accessed"] / TR.HBM_BW)
    assert by in ("compute", "memory")


def test_roofline_peak_by_dtype():
    assert TR.peak_flops("bfloat16") == TR.PEAK_FLOPS == 989e12
    assert TR.peak_flops(torch.float32) == 67e12
    _, tcfg = configs("starcoder2-3b")
    rec = D.step_record(dataclasses.replace(tcfg, dtype=torch.float32),
                        "prefill", batch=B, seq_len=S)
    assert rec["dtype"] == "float32"
    assert TR.terms(rec)["t_compute_s"] == rec["cost"]["flops"] / 67e12


# -- decode bytes against chip_smoke.py's hand formulas --------------------------

def size(tree) -> int:
    return sum(t.numel() * t.element_size() for t in TMB.tree_leaves(tree))


@pytest.mark.parametrize("arch", ["dbrx-132b", "rwkv6-1.6b", "zamba2-1.2b",
                                  "seamless-m4t-large-v2"])
def test_decode_bytes_equal_hand_formulas(arch):
    """`[moe lm]`: every weight but the embedding; `[ssm lm]`: that plus the
    shared block once more per application after the first;
    `[encdec lm]` (`encdec_step_bytes`): the decoder weights but the cross
    wk / wv, the head and final norm, the cross K/V cache and the self K/V
    up to pos. Added here, as the formulas leave them out: the tokens read,
    the embedding rows gathered, the logits written; the K/V slot each
    attention layer writes; K8's window of the self K/V (moe, hybrid);
    each recurrent state read and written in place (rwkv6's wkv is read
    twice, by the bonus term and by the decay update)."""
    _, cfg = configs(arch)
    pos = S - 1
    rec = D.step_record(cfg, "decode", batch=B, seq_len=S, cache_len=pos,
                        enc_len=enc_len(cfg))
    args = D.step_inputs(cfg, "decode", batch=B, seq_len=S,
                         enc_len=enc_len(cfg))
    p, c = args["params"], args["cache"]
    it = cfg.dtype.itemsize
    if cfg.arch_type == "encdec":
        blocks = p["blocks"]
        hand = (size(blocks) - size(blocks["cross"]["wk"])
                - size(blocks["cross"]["wv"]) + size(p["head"])
                + size(p["final_norm"]) + size(c["cross_k"])
                + size(c["cross_v"]) + 2 * c["k"][:, :, :pos + 1].numel() * it)
    else:
        hand = size(p) - size(p["embed"])
        if cfg.arch_type == "hybrid":
            hand += (TZ.shared_applications(cfg) - 1) * size(p["shared_attn"])
    extra = B * 4 + B * cfg.d_model * it + B * cfg.vocab * it
    attn_layers = (TZ.shared_applications(cfg) if cfg.arch_type == "hybrid"
                   else 0 if cfg.arch_type == "ssm" else cfg.n_layers)
    slot = B * cfg.n_kv_heads * cfg.hd * it
    extra += 2 * attn_layers * slot
    if cfg.arch_type in ("moe", "hybrid"):
        extra += 2 * attn_layers * (pos + 1) * slot
    if cfg.arch_type == "ssm":
        extra += 2 * size(c["tm_shift"]) + 2 * size(c["cm_shift"])
        extra += 3 * size(c["wkv"])
    if cfg.arch_type == "hybrid":
        extra += 2 * size(c["conv"]) + 2 * size(c["ssm"])
    assert rec["cost"]["bytes accessed"] == hand + extra


def test_decode_k8_window_reads():
    """gemma3's decode: the global layer's K8 reads pos + 1 slots, the
    ring layer's its W slots; the report's bytes grow by exactly K8's
    window as pos moves, and no other term does."""
    _, cfg = configs("gemma3-27b")
    slot = B * cfg.n_kv_heads * cfg.hd * cfg.dtype.itemsize
    w = cfg.sliding_window
    by = {pos: D.step_record(cfg, "decode", batch=B, seq_len=S,
                             cache_len=pos)["cost"]["bytes accessed"]
          for pos in (0, w - 1, S - 1)}
    # from pos 0 to W - 1 both layers' windows grow by W - 1 slots of K, V
    assert by[w - 1] - by[0] == 2 * 2 * (w - 1) * slot
    # past W the ring's window is full: only the global layer's grows
    assert by[S - 1] - by[w - 1] == 2 * (S - w) * slot


def test_step_record_memory_and_keys():
    _, cfg = configs("starcoder2-3b")
    rec = D.step_record(cfg, "train", batch=B, seq_len=S)
    for key in ("arch", "shape", "step", "tokens", "cache_bytes", "params",
                "active_params", "n_layers", "d_model", "n_experts", "top_k",
                "n_chips", "variant", "trace_s", "memory", "cost",
                "dot_flops_per_device", "bytes_per_device", "roofline",
                "fits_one_card"):
        assert key in rec
    p_bytes = cfg.param_count() * cfg.dtype.itemsize
    mem = rec["memory"]
    # params, Adam's m and v, its step and the batch's int32 tokens and
    # targets
    assert mem["argument_size_in_bytes"] == 3 * p_bytes + 4 + 2 * B * S * 4
    # new params, m, v, step and the loss
    assert mem["output_size_in_bytes"] == 3 * p_bytes + 4 + 4
    # the functional Adam step holds the new state beside the old
    assert mem["temp_size_in_bytes"] >= mem["output_size_in_bytes"]
    assert rec["fits_one_card"] and rec["n_chips"] == 1
    assert rec["tokens"] == B * S


# -- K8 and the other kernels on meta ---------------------------------------------

def k8_inputs(device, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 64, generator=g, dtype=dtype)
    k = torch.randn(2, 40, 2, 64, generator=g, dtype=dtype)
    v = torch.randn(2, 40, 2, 64, generator=g, dtype=dtype)
    return q.to(device), k.to(device), v.to(device)


@pytest.mark.parametrize("cache_len,window", [(39, ops.NO_WINDOW), (20, 8),
                                              (3, 16)])
def test_k8_meta_branch(cache_len, window):
    """On meta: the (B, H, hd) output in q's dtype, no launch counted, and
    the work of `swa_decode_work` reported to the sink; the CPU path in the
    same context stays bit-equal to the plain version and reports none."""
    ops.reset_launch_counts()
    seen = []
    q, k, v = k8_inputs("meta", torch.bfloat16)
    with ops.kernel_work_sink(lambda *a: seen.append(a)):
        out = ops.swa_decode(q, k, v, cache_len, window=window)
        cq, ck, cv = k8_inputs("cpu")
        cpu = ops.swa_decode(cq, ck, cv, cache_len, window=window)
    assert out.device.type == "meta" and out.dtype == torch.bfloat16
    assert tuple(out.shape) == (2, 8, 64)
    assert ops.launch_counts()["swa_decode"] == 0
    assert len(seen) == 1
    name, operations, reads, got_out = seen[0]
    n_valid = min(cache_len + 1, window)
    assert name == "swa_decode" and got_out is out
    assert operations == 4 * 2 * 8 * n_valid * 64
    kv = 2 * n_valid * 2 * 64 * 2
    assert [(t is x, nb) for (t, nb), x in zip(reads, (q, k, v))] == [
        (True, 2 * 8 * 64 * 2), (True, kv), (True, kv)]
    assert ops.swa_decode_work(2, 8, 2, 64, 2, cache_len, window) == (
        operations, 2 * kv, 2 * 8 * 64 * 2)
    assert torch.equal(cpu, ops.swa_decode_ref(cq, ck, cv, cache_len, window))
    # no sink: the meta call still returns its output
    assert ops.swa_decode(q, k, v, cache_len, window=window).shape == out.shape
    with pytest.raises(ValueError, match="swa_decode"):
        ops.swa_decode(q, k, v, 40)          # cache_len outside the cache


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name", ["cascade_score_batched", "cascade_filter",
                                  "cascade_loss_fused", "cascade_score",
                                  "cascade_score_fm", "query_bias"])
def test_other_kernels_refuse_meta(name):
    """No other kernel lies on a traced step: its wrapper raises a
    ValueError naming the kernel on a meta tensor, and launches nothing."""
    calls = {
        "cascade_score_batched": lambda: ops.cascade_score_batched(
            _meta(2, 4, 8), _meta(3, 8), _meta(2, 3)),
        "cascade_filter": lambda: ops.cascade_filter(
            _meta(2, 4, 8), _meta(3, 8), _meta(2, 3), _meta(2, 4),
            _meta(2)),
        "cascade_loss_fused": lambda: ops.cascade_loss_fused(
            _meta(2, 4, 12), _meta(3, 8), _meta(2, 3)),
        "cascade_score": lambda: ops.cascade_score(_meta(4, 8), _meta(3, 8),
                                                   _meta(3)),
        "cascade_score_fm": lambda: ops.cascade_score_fm(
            _meta(8, 4), _meta(3, 8), _meta(3)),
        "query_bias": lambda: ops.query_bias(_meta(2, 8), _meta(3, 8),
                                             _meta(3)),
    }
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=name.removesuffix("_fused")):
        calls[name]()
    assert not any(ops.launch_counts().values())


def test_shape_structs_allocate_nothing():
    _, cfg = configs("dbrx-132b")
    tree = TMB.shape_structs(TZ.templates(cfg), torch.bfloat16)
    for t, tmpl in zip(TMB.tree_leaves(tree),
                       TMB.tree_leaves(TZ.templates(cfg))):
        assert t.device.type == "meta" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == tmpl.shape


# -- the CLI ------------------------------------------------------------------------

def test_cli_decode_32k_at_full_size(tmp_path, capsys):
    """starcoder2-3b at its published size, decode_32k: 128 sequences, a
    cache of 32768 positions, K8 once per layer over all of it."""
    D.main(["--arch", "starcoder2-3b", "--shape", "decode_32k", "--out",
            str(tmp_path)])
    assert "[ ok ] starcoder2-3b x decode_32k" in capsys.readouterr().out
    rec = json.loads((tmp_path / "starcoder2-3b__decode_32k__h100.json")
                     .read_text())
    cfg = TCFG.get("starcoder2-3b")
    assert rec["status"] == "ok" and rec["arch"] == "starcoder2-3b"
    assert rec["params"] == cfg.param_count()
    assert rec["kernel_calls"] == {"swa_decode": cfg.n_layers}
    assert rec["tokens"] == 128 and rec["cache_len"] == 32767
    cache = 2 * cfg.n_layers * 128 * 32768 * cfg.n_kv_heads * cfg.hd * 2
    assert rec["cache_bytes"] == cache
    # K8 reads the whole cache once
    assert rec["cost"]["bytes accessed"] > cache
    assert rec["roofline"]["dominant"] == "memory"
    assert rec["memory"]["argument_size_in_bytes"] > cache


def test_cli_skips_and_refuses(tmp_path, capsys):
    D.main(["--arch", "yi-34b", "--shape", "long_500k", "--out",
            str(tmp_path)])
    out = capsys.readouterr().out
    ok, why = SH.applicable(TCFG.get("yi-34b"), "long_500k")
    assert not ok and f"[skip] yi-34b x long_500k: {why}" in out
    rec = json.loads((tmp_path / "yi-34b__long_500k__h100.json").read_text())
    assert rec["status"] == "skipped" and rec["skipped"] == why
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "no-such-arch", "--out", str(tmp_path)], cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "no-such-arch" in bad.stderr


def test_recommended_variant():
    assert D.recommended_variant(TCFG.get("zamba2-1.2b"), "train_4k") == \
        "chunked"
    assert D.recommended_variant(TCFG.get("rwkv6-1.6b"), "decode_32k") == \
        "baseline"
    assert D.recommended_variant(TCFG.get("gemma3-27b"), "prefill_32k") == \
        "baseline"
