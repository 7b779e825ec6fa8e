"""Plain PyTorch version of the sliding-window decode attention (K8), the
port of the reference's `swa_decode_ref`
(src/repro/kernels/swa_decode/ref.py).

One new query token per sequence attends to a KV cache of S slots, masked
to positions (cache_len - window, cache_len] (window=NO_WINDOW => full
causal decode). Logits q.k/sqrt(hd) and the softmax in float32; the
output in q's dtype. GQA: query head j reads kv head j // (H / Hkv),
computed with grouped-head einsums, so the K/V expansion is never
materialized.
"""

from __future__ import annotations

import math

import torch

NO_WINDOW = 1 << 30


def swa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cache_len: int, window: int = NO_WINDOW) -> torch.Tensor:
    """q: (B, H, hd); k/v: (B, S, Hkv, hd); cache_len: the query position
    (cache slots <= cache_len are written). Returns (B, H, hd)."""
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, hd).float()
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, k.float()) / math.sqrt(hd)
    pos = torch.arange(s, device=q.device)
    mask = (pos <= cache_len) & (pos > cache_len - window)
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v.float())
    return out.reshape(b, h, hd).to(q.dtype)
