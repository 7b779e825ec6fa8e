"""Functional building blocks of the dense model family.

Plain functions over explicit parameter dicts, with the reference's
conventions (src/repro/models/layers.py):
  x: (B, S, d_model) activations
  attention weights stored 2-D flattened (d_model, H*hd); heads are
  recovered by reshape inside the op.

Decode attention of one token runs K8 (`kernels.ops.swa_decode`): the
hand-written flash-decode kernel on a CUDA tensor, its plain version on a
CPU tensor. The reference's mesh-only variants (`shmap_attention`,
`_seq_shard`, `attn_shard="seqkv"`) are not ported: the port runs on one
card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Norms and activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the (1 + gamma) scale, cast back to x's
    dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


def swiglu(x, wg, wi, wo):
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def gelu_mlp(x, wi, wo):
    # jax.nn.gelu defaults to the tanh approximation; torch's default is erf
    return F.gelu(x @ wi, approximate="tanh") @ wo


def mlp(x, p, act: str):
    if act == "swiglu":
        return swiglu(x, p["wg"], p["wi"], p["wo"])
    return gelu_mlp(x, p["wi"], p["wo"])


# ---------------------------------------------------------------------------
# RoPE (split halves, not interleaved)
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, hd: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (B, S, 1, hd/2) float32, for positions (B, S) or
    (S,)."""
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=positions.device) / hd))
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs            # (B, S, hd/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S) or (S,)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm, sliding window, blockwise for long seq)
# ---------------------------------------------------------------------------

_BLOCKWISE_THRESHOLD = 8192   # use online-softmax KV chunking above this
_KV_CHUNK = 1024
NO_WINDOW = ops.NO_WINDOW     # "no window": a huge int, as in the reference


def _expand_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv*n_rep, hd) by repeat (GQA): query head
    j reads kv head j // n_rep."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(Sq, Sk) boolean mask, True = attend; NO_WINDOW disables the bound."""
    diff = q_pos[:, None] - k_pos[None, :]
    m = diff < window
    if causal:
        m &= diff >= 0
    return m


def dot_attention(q, k, v, *, causal: bool, window: int = NO_WINDOW,
                  q_offset: int = 0) -> torch.Tensor:
    """Full materialized attention. q: (B,Sq,H,hd), k/v: (B,Sk,Hkv,hd)."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    k = _expand_kv(k, h // hkv)
    v = _expand_kv(v, h // hkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    mask = _attn_mask(q_pos, torch.arange(sk, device=q.device), causal,
                      window)
    scores = torch.where(mask[None, None], scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def blockwise_attention(q, k, v, *, causal: bool, window: int = NO_WINDOW,
                        q_offset: int = 0,
                        kv_chunk: int = _KV_CHUNK) -> torch.Tensor:
    """Online-softmax attention over KV chunks: O(Sq*chunk) memory instead
    of O(Sq*Sk). The flash-attention recurrence in plain PyTorch (K8 covers
    decode; this covers long prefill)."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    q_pos = q_offset + torch.arange(sq, device=q.device)
    qf = q.float()
    m = torch.full((b, h, sq), -torch.inf, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, hd), device=q.device)
    for c0 in range(0, sk, kv_chunk):
        kb = _expand_kv(k[:, c0:c0 + kv_chunk], n_rep).float()
        vb = _expand_kv(v[:, c0:c0 + kv_chunk], n_rep).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb) / math.sqrt(hd)
        k_pos = c0 + torch.arange(kb.shape[1], device=q.device)
        s = torch.where(_attn_mask(q_pos, k_pos, causal, window)[None, None],
                        s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        scale = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * scale + p.sum(-1)
        acc = acc * scale[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                 # (B, Sq, H, hd)


def _full_attention(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    fn = (blockwise_attention if k.shape[1] > _BLOCKWISE_THRESHOLD
          else dot_attention)
    return fn(q, k, v, causal=causal, window=window)


def attention(p, cfg, x, *, positions, causal: bool = True,
              window: int = NO_WINDOW, kv_cache: dict | None = None,
              cache_len: int | None = None, mode: str = "decode",
              ring_window: int = 0):
    """Full attention op: projections + rope + (cached) attention + out proj.

    kv_cache: {"k","v"}: (B, S_max, Hkv, hd) written IN PLACE at the host
    int cache_len (or, with ring_window=W, a (B, W, Hkv, hd) ring buffer,
    slot = position % W). mode: "decode" attends q against the whole cache;
    "prefill" writes the fresh K/V into the cache but attends only against
    the fresh keys (the cache starts empty). Returns (out, kv_cache)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if kv_cache is None:
        out = _full_attention(q, k, v, causal=causal, window=window)
        return out.reshape(b, s, h * hd) @ p["wo"], None
    ck, cv = kv_cache["k"], kv_cache["v"]
    if ring_window:
        w = ring_window
        if mode == "prefill":
            out = _full_attention(q, k, v, causal=causal, window=w)
            m = min(s, w)
            slots = torch.arange(s - m, s, device=x.device) % w
            ck[:, slots] = k[:, -m:].to(ck.dtype)
            cv[:, slots] = v[:, -m:].to(cv.dtype)
        else:
            if s != 1:
                raise ValueError(f"ring-buffer decode writes one token, "
                                 f"got {s}")
            slot = cache_len % w
            ck[:, slot:slot + 1] = k.to(ck.dtype)
            cv[:, slot:slot + 1] = v.to(cv.dtype)
            out = decode_attention(q, ck, cv, q_offset=cache_len, window=w,
                                   ring=True)
    else:
        if cache_len + s > ck.shape[1]:
            raise ValueError(f"cache of {ck.shape[1]} positions cannot take "
                             f"{s} more at {cache_len}")
        ck[:, cache_len:cache_len + s] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + s] = v.to(cv.dtype)
        if mode == "prefill":
            out = _full_attention(q, k, v, causal=causal, window=window)
        else:
            out = decode_attention(q, ck, cv, q_offset=cache_len,
                                   window=window)
    return out.reshape(b, s, h * hd) @ p["wo"], kv_cache


def decode_attention(q, k, v, *, q_offset: int, window: int = NO_WINDOW,
                     ring: bool = False) -> torch.Tensor:
    """Attention of the one query token at position q_offset (q: (B, 1, H,
    hd)) against a KV cache (B, Sk, Hkv, hd) whose slots up to q_offset are
    written — the reference's `decode_attention` with its `valid_len =
    q_offset + 1`, which K8's `pos <= cache_len` already implies.

    ring=True: the cache is a ring buffer of Sk slots, slot s holding the
    most recent position congruent to s mod Sk (the reference passes
    `k_pos=ring_slot_positions(q_offset + 1, Sk)`); window >= Sk.

    Runs K8 (`ops.swa_decode`: the CUDA kernel on the card, its plain
    version on the CPU). A ring maps onto K8 exactly: after the new K/V is
    written, the valid slots are 0..min(q_offset, Sk - 1), every one of
    them inside the window, and softmax does not depend on slot order — so
    it is K8 with no window and cache_len min(q_offset, Sk - 1) over the
    ring."""
    sq, sk = q.shape[1], k.shape[1]
    if sq != 1:
        raise ValueError(f"decode_attention decodes one token at a time "
                         f"through K8, got {sq}")
    if ring:
        if window < sk:
            raise ValueError(f"a ring of {sk} slots needs window >= {sk}, "
                             f"got {window}")
        return ops.swa_decode(q[:, 0], k, v, min(q_offset, sk - 1),
                              window=NO_WINDOW)[:, None]
    return ops.swa_decode(q[:, 0], k, v, q_offset, window=window)[:, None]


def ring_slot_positions(cache_len: int, window: int,
                        device=None) -> torch.Tensor:
    """Positions held by each ring-buffer slot: the most recent position
    p < cache_len with p = s (mod W); -1 if no such position exists yet."""
    s = torch.arange(window, device=device)
    p = s + torch.div(cache_len - 1 - s, window,
                      rounding_mode="floor") * window
    return torch.where(p >= 0, p, -1)
