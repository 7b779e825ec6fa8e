"""Roofline of a step on H100s: the port of the reference's
`launch/roofline.py`, priced at one card's peaks and an H100 machine's
links.

    compute    = FLOPs / peak FLOP/s of the step's dtype
    memory     = bytes / HBM bandwidth
    collective = each collective's result bytes / its link's rate

The reference prices a compiled XLA artifact of a 256-chip TPU v5e pod.
Its `HloCost`, `collective_bytes` and `hlo_flops` parse the optimized HLO
(dot FLOPs per while-loop trip, collective result bytes) and have no
counterpart here: the cost report (`launch/dryrun.py`) counts the FLOPs
and bytes of a step by tracing it on `meta` tensors. The one-card report
runs unsharded, moves nothing between cards, and keeps two terms; the
pod dry run traces one rank's step over the counting transport
(`ModelParallel.counting`), whose log gives each collective's kind, the
bytes the rank puts in and the ranks of its group. `collectives` turns
that log into the reference's record (result bytes and calls by kind) and
prices each call at its link:

  * NVLINK_BW, 450 GB/s: NVLink 4 moves 900 GB/s a GPU, 450 GB/s each
    way (NVIDIA H100 SXM5 datasheet), for a collective whose ranks lie in
    one NVLINK_DOMAIN of 8 GPUs (an HGX H100 board; ranks numbered
    row-major, so global ranks 8k .. 8k + 7 share one);
  * IB_BW, 50 GB/s: one 400 Gb/s NDR InfiniBand port a GPU (a DGX H100's
    eight ConnectX-7 ports), for a collective that spans more than one
    domain. The production mesh's "model" axis of 16 spans two.

As the reference's term, a call costs its result bytes over the rate (no
ring factor). `terms` keeps the reference's work terms (`model_flops`,
`useful_fraction`); `streaming_floor_bytes` is the reference's, line for
line.
"""

from __future__ import annotations

import torch

# One NVIDIA H100 SXM5 (80GB HBM3, 700 W), dense rates from the datasheet.
PEAK_FLOPS = 989e12          # bf16 / fp16 tensor-core FLOP/s
# the matmul peak by the dtype a step's weights are in: float32 matmuls run
# outside the tensor cores (the port leaves TF32 off)
PEAK_FLOPS_BY_DTYPE = {torch.bfloat16: 989e12, torch.float16: 989e12,
                       torch.float32: 67e12}
HBM_BW = 3.35e12             # bytes/s of device memory
CARD_BYTES = 80e9            # device memory of one card
NVLINK_BW = 450e9            # bytes/s each way, NVLink 4, within a domain
IB_BW = 50e9                 # bytes/s, one 400 Gb/s NDR port a GPU
NVLINK_DOMAIN = 8            # GPUs an NVLink domain joins


def peak_flops(dtype: str | torch.dtype) -> float:
    """The card's matmul peak for a step in `dtype` (a torch dtype or its
    name, as a record stores it)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return PEAK_FLOPS_BY_DTYPE[dtype]


def result_bytes(kind: str, nbytes: int, n: int) -> int:
    """The bytes of a collective's result (what the reference's `HloCost`
    counts: the HLO result shape) from the bytes one rank puts in
    (`ModelParallel.bytes`) over a group of n ranks: an all-reduce's
    result is its input; an all-gather's is the n shards; a
    reduce-scatter's is one of the n blocks its input holds."""
    if kind == "all_gather":
        return nbytes * n
    if kind == "reduce_scatter":
        return nbytes // n
    if kind in ("all_reduce_sum", "all_reduce_max"):
        return nbytes
    raise ValueError(f"collective {kind!r}")


def link(members) -> str:
    """"nvlink" where every global rank of a collective's group lies in
    one NVLINK_DOMAIN, else "ib"."""
    return ("nvlink" if len({r // NVLINK_DOMAIN for r in members}) == 1
            else "ib")


def collectives(log) -> dict:
    """The reference's collective record of a rank's step from its
    counting transport's log ((kind, bytes put in, group ranks, element
    bytes) per call):
    `{kind}_bytes` (result bytes) and `{kind}_count` per kind, their
    `total_bytes`, and the result bytes on each link (`nvlink_bytes`,
    `ib_bytes`)."""
    out: dict = {"total_bytes": 0, "nvlink_bytes": 0, "ib_bytes": 0}
    for kind, nbytes, members, _ in log:
        n = result_bytes(kind, nbytes, len(members))
        out[f"{kind}_bytes"] = out.get(f"{kind}_bytes", 0) + n
        out[f"{kind}_count"] = out.get(f"{kind}_count", 0) + 1
        out["total_bytes"] += n
        out[f"{link(members)}_bytes"] += n
    return out


def collective_s(coll: dict) -> float:
    """The collective term of a record's `collectives`: each link's result
    bytes over its rate."""
    return coll["nvlink_bytes"] / NVLINK_BW + coll["ib_bytes"] / IB_BW


def terms(rec: dict, n_chips: int = 1) -> dict:
    """The roofline terms (seconds) of a cost record: its FLOPs over the
    card's peak for the record's dtype, its bytes (`bytes_per_device`, the
    larger of the counted bytes and the streaming floor) over the HBM
    bandwidth, where the record has `collectives` (a rank of the pod dry
    run) their term (`collective_s`), the largest, and the reference's
    work terms."""
    flops_dev = rec.get("dot_flops_per_device", 0.0)
    if not flops_dev:
        flops_dev = rec.get("cost", {}).get("flops", 0.0)
    hbm_dev = rec.get("bytes_per_device", 0.0)
    if not hbm_dev:
        hbm_dev = rec.get("cost", {}).get("bytes accessed", 0.0)
    t = {"compute": flops_dev / peak_flops(rec.get("dtype", "bfloat16")),
         "memory": hbm_dev / HBM_BW}
    if "collectives" in rec:
        t["collective"] = collective_s(rec["collectives"])
    out = {f"t_{k}_s": v for k, v in t.items()}
    out["dominant"] = max(t, key=t.get)
    n_active = rec.get("active_params", 0)
    tokens = rec.get("tokens", 0)
    if tokens and n_active:
        mult = 6 if rec.get("step") == "train" else 2
        model_flops = float(mult) * n_active * tokens
        out["model_flops"] = model_flops
        total = flops_dev * n_chips
        out["flops_global"] = total
        out["useful_fraction"] = model_flops / total if total else 0.0
    return out


def bound(rec: dict) -> tuple[float, str]:
    """The least time a card could take for the counted work of a record,
    max(FLOPs / peak, bytes accessed / HBM bandwidth, and for a rank of the
    pod dry run its collective term), in seconds, and which it is
    ("compute", "memory" or "collective"). A measured step faster than
    this means the count is wrong."""
    t = {"compute": rec["cost"]["flops"] / peak_flops(rec["dtype"]),
         "memory": rec["cost"]["bytes accessed"] / HBM_BW}
    if "collectives" in rec:
        t["collective"] = collective_s(rec["collectives"])
    by = max(t, key=t.get)
    return t[by], by


def streaming_floor_bytes(rec: dict, n_chips: int) -> float:
    """Analytic lower bound on per-device HBM traffic for one step.

    train:   weights read in fwd+bwd, grads written+read, Adam moments
             read+written (~6x params) + activation traffic
             (~n_layers * d_model * 24B per token with remat re-reads).
    prefill: weights once + cache written once + activations once.
    decode:  weights touched once (MoE: only experts hit by this batch,
             ~min(E, B*top_k)/E of expert weights + shared) + cache read.
    """
    p_bytes = rec.get("params", 0) * 2
    cache = rec.get("cache_bytes", 0)
    tokens = rec.get("tokens", 0)
    act_per_tok = rec.get("n_layers", 0) * rec.get("d_model", 0) * 24
    step = rec.get("step")
    if step == "train":
        total = 6 * p_bytes + tokens * act_per_tok
    elif step == "prefill":
        total = p_bytes + cache + tokens * act_per_tok // 3
    else:
        e, k = rec.get("n_experts", 0), rec.get("top_k", 0)
        if e:
            a_bytes = rec.get("active_params", 0) * 2
            expert_frac = min(1.0, tokens * k / e)
            touched = a_bytes + (p_bytes - a_bytes) * expert_frac
        else:
            touched = p_bytes
        total = touched + cache
    return total / n_chips
