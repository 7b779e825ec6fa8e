"""Plain PyTorch version of the sliding-window decode attention (K8), the
port of the reference's `swa_decode_ref`
(src/repro/kernels/swa_decode/ref.py).

One new query token per sequence attends to a KV cache of S slots, masked
to positions (cache_len - window, cache_len] (window=NO_WINDOW => full
causal decode). Logits q.k/sqrt(hd) and the softmax in float32; the
output in q's dtype. GQA: query head j reads kv head j // (H / Hkv),
computed with grouped-head einsums, so the K/V expansion is never
materialized.

`swa_decode_partial_ref` is K8's partials mode: the unnormalised softmax
state (m, l, acc) of one block of slots, which
`models.parallel.combine_partials` turns into the output.
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


def swa_decode_partial_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lo: int, hi: int
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The softmax partials of q (B, H, hd) over the slots [lo, hi) of one
    block k/v (B, S, Hkv, hd): m (B, H), the largest logit q.k/sqrt(hd)
    (natural-log units, as the reference's `blockwise_attention` stats),
    l (B, H) = sum exp(logit - m) and acc (B, H, hd) = sum exp(logit - m)
    v, all float32, acc unnormalised. An empty range (lo >= hi) gives m =
    -inf, l = 0, acc = 0."""
    b, h, hd = q.shape
    hkv = k.shape[2]
    if lo >= hi:
        return (torch.full((b, h), -torch.inf, device=q.device),
                torch.zeros((b, h), device=q.device),
                torch.zeros((b, h, hd), device=q.device))
    qg = q.reshape(b, hkv, h // hkv, hd).float()
    logits = torch.einsum("bgrd,bsgd->bgrs", qg,
                          k[:, lo:hi].float()) / math.sqrt(hd)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    acc = torch.einsum("bgrs,bsgd->bgrd", p, v[:, lo:hi].float())
    return m.reshape(b, h), p.sum(-1).reshape(b, h), acc.reshape(b, h, hd)

