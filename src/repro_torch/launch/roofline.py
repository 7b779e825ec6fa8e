"""Roofline of one step on one H100: the port of the reference's
`launch/roofline.py`, priced at one card's peaks.

    compute = FLOPs / peak FLOP/s of the step's dtype
    memory  = bytes / HBM bandwidth

The reference prices a compiled XLA artifact of a 256-chip TPU v5e pod
and adds a third, collective term. Its `HloCost`, `collective_bytes` and
`hlo_flops` parse the optimized HLO (dot FLOPs per while-loop trip,
collective result bytes) and have no counterpart here: the port runs
eagerly and unsharded on one card, so the cost report
(`launch/dryrun.py`) counts the FLOPs and bytes of a step by tracing it
on `meta` tensors, and no collective runs. `terms` keeps the reference's
work terms (`model_flops`, `useful_fraction`) and drops the collective
one; `streaming_floor_bytes` is the reference's, line for line.
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


def peak_flops(dtype: str | torch.dtype) -> float:
    """The card's matmul peak for a step in `dtype` (a torch dtype or its
    name, as a record stores it)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return PEAK_FLOPS_BY_DTYPE[dtype]


def terms(rec: dict, n_chips: int = 1) -> dict:
    """The roofline terms (seconds) of a cost record: its FLOPs over the
    card's peak for the record's dtype, its bytes (`bytes_per_device`, the
    larger of the counted bytes and the streaming floor) over the HBM
    bandwidth, the larger of the two, and the reference's work terms."""
    flops_dev = rec.get("dot_flops_per_device", 0.0)
    if not flops_dev:
        flops_dev = rec.get("cost", {}).get("flops", 0.0)
    hbm_dev = rec.get("bytes_per_device", 0.0)
    if not hbm_dev:
        hbm_dev = rec.get("cost", {}).get("bytes accessed", 0.0)
    t_compute = flops_dev / peak_flops(rec.get("dtype", "bfloat16"))
    t_memory = hbm_dev / HBM_BW
    out = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "dominant": "compute" if t_compute >= t_memory else "memory",
    }
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
    """The least time one card could take for the counted work of a
    record, max(FLOPs / peak, bytes accessed / HBM bandwidth), in seconds,
    and which of the two it is ("compute" or "memory"). A measured step
    faster than this means the count is wrong."""
    t_compute = rec["cost"]["flops"] / peak_flops(rec["dtype"])
    t_memory = rec["cost"]["bytes accessed"] / HBM_BW
    return max(t_compute, t_memory), ("compute" if t_compute >= t_memory
                                      else "memory")


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
