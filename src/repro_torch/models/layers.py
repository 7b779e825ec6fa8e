"""Functional building blocks of the model zoo: attention, MLPs and the
moe layer of the dense and moe families, and the sequence mixers of the
ssm (RWKV-6) and hybrid (Mamba2) families.

Plain functions over explicit parameter dicts, with the reference's
conventions (src/repro/models/layers.py):
  x: (B, S, d_model) activations
  attention weights stored 2-D flattened (d_model, H*hd); heads are
  recovered by reshape inside the op.

Decode attention of one token runs K8 (`kernels.ops.swa_decode`): the
hand-written flash-decode kernel on a CUDA tensor, its plain version on a
CPU tensor; so does an encoder-decoder's cross attention of one query
over the cached encoder K/V (K8's partials mode where that cache is cut
over its frames). Under model parallelism (`models.parallel`;
every family) attention and the MLP run on a rank's shard as they are:
the head counts come from the local weights' shapes (where the ranks do
not divide the kv heads, a rank's kv heads are the ones its query heads
read, `parallel.kv_heads`, so the local GQA is the reference's), and the
caller sums the output projection's partial sums over the ranks; the
expert-parallel `moe_ffn_shmap` routes over every expert, runs the
rank's own and sums over the ranks itself. The reference's
sequence-sharded variants (cfg.attn_shard "seqkv" / "shmap", its
`_seq_shard` constraints and `shmap_attention`) cut the keys over the
ranks instead: `attention`
gathers the rank's q / k / v heads whole where a step needs them, each
rank attends over its block of the keys and `models.parallel
.combine_partials` merges the ranks' softmax states — `shmap_attention`
over fresh keys (a forward, a prefill), `seq_decode_attention` (K8's
partials mode) over a cache leaf cut over the sequence ("seq" layout) at
decode — and the rank keeps its own heads of the output for its rows of
wo. The Mamba2 and RWKV-6 mixers run a rank's heads the same way: their
head counts come from the local weights, the whole leaves indexed per
head (dt_bias / A_log / D, w0 / u / the decay LoRA's output) are taken at
the rank's heads, Mamba2's out_norm over the whole d_inner sums its
squares over the ranks (`rms_norm_cut`), and RWKV-6's channel mix reduces
and gathers itself. In training the inputs and whole leaves that every
rank computes the same and uses on its own heads enter through
`parallel.enter_partial`, and those sums through their autograd forms.
The Mamba2 and RWKV-6 recurrences have no kernel in
the reference (it leaves them to XLA's `jax.lax.scan`), and run here as
plain PyTorch loops over the sequence or its chunks.
"""

from __future__ import annotations

import contextlib
import functools
import math
import operator
import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.parallel import (SEQ_VARIANTS, combine_partials,
                                         enter_partial, gather_last,
                                         kv_gather_index, kv_slots, q_heads,
                                         q_split, reduce_partial,
                                         reduce_shared, sum_over)

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
                        q_offset: int = 0, kv_chunk: int = _KV_CHUNK,
                        k_offset: int = 0, return_stats: bool = False):
    """Online-softmax attention over KV chunks: O(Sq*chunk) memory instead
    of O(Sq*Sk). The flash-attention recurrence in plain PyTorch (K8 covers
    decode; this covers long prefill). The keys sit at positions k_offset
    .. k_offset + Sk - 1 (a rank's block of them under `shmap_attention`).
    return_stats: the softmax state instead of the output, (m, l, acc) of
    shapes (B, H, Sq), (B, H, Sq), (B, H, Sq, hd), float32, m in natural-log
    units. A masked logit is -1e30, as in the reference, so a row with no
    key in the block has m = -1e30 (and an l that counts its keys; the
    reference's also counts its zero padding of the last chunk); such a
    row's weight in a combine is 0."""
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
        k_pos = k_offset + c0 + torch.arange(kb.shape[1], device=q.device)
        s = torch.where(_attn_mask(q_pos, k_pos, causal, window)[None, None],
                        s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        scale = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * scale + p.sum(-1)
        acc = acc * scale[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    if return_stats:
        return m, l, acc
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                 # (B, Sq, H, hd)


def shmap_attention(q, k_loc, v_loc, mp, *, causal: bool,
                    window: int = NO_WINDOW, q_offset: int = 0,
                    k_offset: int = 0,
                    wire: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Sequence-sharded attention (the reference's `shmap_attention`): q
    (B, Sq, H, hd) whole on every rank, k_loc / v_loc (B, Sk_loc, Hkv, hd)
    the rank's block of the keys, at positions k_offset ...; each rank's
    blockwise softmax state (chunks of min(1024, max(Sk_loc // 4, 8))
    keys, as the reference) combined over the ranks by `combine_partials`:
    l in float32, acc crossing in `wire` (bfloat16 as the reference's
    psum; float32 for the "seqkv" variant, whose reference GSPMD reduces
    in float32). Returns (B, Sq, H, hd) in q's dtype, the same bits on
    every rank."""
    m, l, acc = _block_state(q, k_loc, v_loc, causal=causal, window=window,
                             q_offset=q_offset, k_offset=k_offset)
    out = combine_partials(mp, m, l, acc, wire)
    return out.transpose(1, 2).to(q.dtype)


def _block_state(q, k_loc, v_loc, *, causal: bool, window: int,
                 q_offset: int = 0, k_offset: int = 0):
    """The softmax state (m, l, acc) of q over one block of the keys, at
    positions k_offset ..., in the reference's shard_map chunks of
    min(1024, max(Sk_loc // 4, 8)) keys (`blockwise_attention`)."""
    return blockwise_attention(
        q, k_loc, v_loc, causal=causal, window=window, q_offset=q_offset,
        kv_chunk=min(_KV_CHUNK, max(k_loc.shape[1] // 4, 8)),
        k_offset=k_offset, return_stats=True)


def blocked_attention(q, k, v, blocks: int, *, causal: bool,
                      window: int = NO_WINDOW,
                      wire: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """`shmap_attention` over `blocks` ranks, in one process: q (B, Sq, H,
    hd), k / v (B, Sk, Hkv, hd) whole, the keys cut into `blocks` equal
    blocks, each block's softmax state the one its rank would hold, the
    states stacked and combined as the ranks' (`combine_partials` with no
    mp: the max carries no gradient, acc sums in `wire`). Returns (B, Sq,
    H, hd) in q's dtype."""
    n = k.shape[1] // blocks
    states = [_block_state(q, k[:, i * n:(i + 1) * n],
                           v[:, i * n:(i + 1) * n], causal=causal,
                           window=window, k_offset=i * n)
              for i in range(blocks)]
    m, l, acc = (torch.stack(t) for t in zip(*states))
    out = combine_partials(None, m, l, acc, wire)
    return out.transpose(1, 2).to(q.dtype)


# The (data, model) shape of the reference's `layers.MESH` whose
# shard_map semantics a step without ranks keeps (`one_process_mesh`);
# None outside it.
_ONE_PROCESS_MESH: tuple[int, int] | None = None


@contextlib.contextmanager
def one_process_mesh(data: int, model: int):
    """Within: a forward without model parallelism (mp None) of a config
    whose attn_shard is "seqkv" or "shmap" keeps the reference's shard_map
    semantics on a (data, model) mesh, as the reference's jitted step does
    over `data` x `model` host devices, all in this process: attention
    without a cache cuts the keys into `model` blocks wherever they divide
    the sequence (`blocked_attention`), and under "shmap" the experts,
    wherever `model` divides them, run over `data` shards of the batch's
    rows (`moe_ffn_blocks`). The run that a step over ranks of the same
    variant is held to, where the plain step's semantics differ."""
    global _ONE_PROCESS_MESH
    saved, _ONE_PROCESS_MESH = _ONE_PROCESS_MESH, (data, model)
    try:
        yield
    finally:
        _ONE_PROCESS_MESH = saved


def one_process_shape(cfg) -> tuple[int, int] | None:
    """`one_process_mesh`'s (data, model) where cfg keeps its semantics
    (attn_shard "seqkv" or "shmap"), else None."""
    if cfg.attn_shard not in SEQ_VARIANTS:
        return None
    return _ONE_PROCESS_MESH


def seq_decode_attention(q, ck_loc, cv_loc, mp, *, cache_len: int,
                         window: int = NO_WINDOW, offset: int,
                         ring: bool = False) -> torch.Tensor:
    """Decode attention of the one token at position cache_len (q (B, 1,
    H, hd), every head) over a cache cut over the sequence: this rank
    holds slots offset .. offset + n - 1 (ck_loc / cv_loc (B, n, Hkv, hd),
    every kv head) of the leaf's n * world. K8's partials mode
    (`ops.swa_decode_partial`) over the rank's part of the valid slots,
    then `combine_partials` with a float32 wire, as GSPMD reduces the
    reference's `decode_attention` over the sharded cache. The valid
    global slots are the positions (cache_len - window, cache_len] or,
    for a ring of W = n * world slots (window >= W), the slots 0 ..
    min(cache_len, W - 1) with no window (`decode_attention`'s mapping).
    Returns (B, 1, H, hd) in q's dtype, the same bits on every rank."""
    if q.shape[1] != 1:
        raise ValueError(f"seq_decode_attention decodes one token at a "
                         f"time, got {q.shape[1]}")
    n = ck_loc.shape[1]
    if ring:
        if window < n * mp.world:
            raise ValueError(f"a ring of {n * mp.world} slots needs window "
                             f">= it, got {window}")
        lo, hi = 0, min(cache_len, n * mp.world - 1) + 1
    else:
        lo, hi = max(0, cache_len - window + 1), cache_len + 1
    lo, hi = (min(max(a - offset, 0), n) for a in (lo, hi))
    m, l, acc = ops.swa_decode_partial(q[:, 0], ck_loc, cv_loc, lo, hi)
    out = combine_partials(mp, m, l, acc, torch.float32)
    return out.to(q.dtype)[:, None]


def _full_attention(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    fn = (blockwise_attention if k.shape[1] > _BLOCKWISE_THRESHOLD
          else dot_attention)
    return fn(q, k, v, causal=causal, window=window)


def seq_cut(mp, cut: str) -> bool:
    """Whether a rank's K/V cache leaf whose layout tag is `cut` ("heads"
    or "seq", set where the cache is laid out: `serving.engine
    .init_cache`, `cache_cuts`) is cut over its slots (the "seq" layout:
    every kv head, a block of the slots) rather than over the kv heads:
    a "seq" leaf under more than one rank. The tag, not the leaf's shape,
    tells the two apart (a rank holds every kv head under "heads" too
    where the model has one, or where its query heads read them all)."""
    return mp is not None and mp.world > 1 and cut == "seq"


def _gather_heads(mp, cfg, q, k, v) -> list[torch.Tensor]:
    """This rank's query columns q ((B, S, h, hd) heads or (B, S, c) the
    raw columns of a head the ranks split) and the kv heads k, v (B, S,
    n, hd) it holds (`parallel.kv_heads`), each or both None, whole: one
    all-gather of them packed along the last dim (a rank holding fewer kv
    heads than `parallel.kv_slots` pads its own). q comes back (B, S, H,
    hd) in the "tp" layout's column order, k and v (B, S, Hkv, hd) in the
    model's order, a kv head that several ranks hold taken from the first
    (`parallel.kv_gather_index`). Every rank uses the whole, so in
    training the gradient is summed over the ranks and each keeps its
    block (`enter_partial` of `gather_last`). Returns those given, in the
    order q, k, v."""
    b, s = next(t for t in (q, k, v) if t is not None).shape[:2]
    parts = [] if q is None else [q.reshape(b, s, -1)]
    if k is not None:
        n = kv_slots(cfg.n_heads, cfg.n_kv_heads, mp.world)
        parts += [F.pad(t, (0, 0, 0, n - t.shape[2])).reshape(b, s, -1)
                  for t in (k, v) if t is not None]
    sizes = [t.shape[-1] for t in parts]
    full = enter_partial(mp, gather_last(mp, torch.cat(parts, dim=-1)))
    full = full.view(b, s, mp.world, sum(sizes))
    out = [t.reshape(b, s, -1, cfg.hd) for t in full.split(sizes, dim=-1)]
    pick = kv_gather_index(cfg.n_heads, cfg.n_kv_heads, mp.world)
    if pick is not None and k is not None:
        out[-2:] = [t[:, :, pick] for t in out[-2:]]
    return out


def _own_cols(mp, cfg, out: torch.Tensor, first: int = 0) -> torch.Tensor:
    """The rank's columns (B, S, c) of an attention output (B, S, n, hd)
    over the heads first .. first + n - 1: its block of the H·hd, which
    its rows of wo take."""
    c = cfg.n_heads * cfg.hd // mp.world
    return out.reshape(*out.shape[:2], -1).narrow(
        -1, mp.rank * c - first * cfg.hd, c)


class _RankQ:
    """A rank's queries of one attention call and the way its output
    returns to its rows of wo. q: (B, S, c), its columns of x @ wq; prep
    normalises (qk_norm) and ropes heads (B, S, n, hd). Where the ranks
    divide the heads (or without model parallelism) the columns are whole
    heads, prepared at once; where they split them (`parallel.q_split`),
    the raw columns, prepared once gathered whole (a head's norm and rope
    need all hd of it)."""

    def __init__(self, mp, cfg, q: torch.Tensor, prep):
        self.mp, self.cfg, self.prep = mp, cfg, prep
        self.split = q_split(cfg, mp)
        self.q = q if self.split else prep(
            q.reshape(*q.shape[:2], -1, cfg.hd))

    def touched(self) -> range:
        return q_heads(self.cfg.n_heads, self.mp.world, self.mp.rank)

    def local(self) -> torch.Tensor:
        """The heads this rank attends over its own keys: its heads, or
        where the ranks split them the heads its columns touch, gathered
        whole (one all-gather)."""
        if not self.split:
            return self.q
        qf, = _gather_heads(self.mp, self.cfg, self.q, None, None)
        t = self.touched()
        return self.prep(qf[:, :, t.start:t.stop])

    def whole(self, k, v) -> list:
        """[q, k, v] whole (every head and kv head; k / v None to gather
        q alone): one all-gather."""
        qf, *kv = _gather_heads(self.mp, self.cfg, self.q, k, v)
        return [self.prep(qf) if self.split else qf, *kv]

    def own(self, out: torch.Tensor, whole: bool) -> torch.Tensor:
        """The rank's columns (B, S, c) of an output over every head
        (whole) or over `local`'s heads."""
        if whole:
            return _own_cols(self.mp, self.cfg, out)
        if not self.split:
            return out.reshape(*out.shape[:2], -1)
        return _own_cols(self.mp, self.cfg, out, self.touched().start)


def _shmap_fresh(rq: _RankQ, k, v, mp, *, causal: bool, window: int,
                 wire: torch.dtype):
    """`shmap_attention` over the fresh tokens (a forward, a prefill):
    q / k / v gathered whole, the keys cut into the ranks' blocks of S /
    world positions. Returns (the rank's columns of the output (B, S, c),
    k and v whole)."""
    qf, kf, vf = rq.whole(k, v)
    n = kf.shape[1] // mp.world
    blk = slice(mp.rank * n, (mp.rank + 1) * n)
    out = shmap_attention(qf, kf[:, blk], vf[:, blk], mp, causal=causal,
                          window=window, k_offset=mp.rank * n, wire=wire)
    return rq.own(out, True), kf, vf


def _write_block(ck, cv, kf, vf, j0: int, slot0: int, mp) -> None:
    """Write the tokens kf / vf[:, j0:] (every kv head) at the slots
    slot0, slot0 + 1, ... (mod the leaf's n * world) of a cache leaf cut
    over its slots: this rank writes those in its block of n."""
    n = ck.shape[1]
    total, off = n * mp.world, mp.rank * n
    j, slot = j0, slot0 % total
    while j < kf.shape[1]:
        run = min(kf.shape[1] - j, total - slot)
        lo, hi = max(slot, off), min(slot + run, off + n)
        if lo < hi:
            rows = slice(j + lo - slot, j + hi - slot)
            ck[:, lo - off:hi - off] = kf[:, rows].to(ck.dtype)
            cv[:, lo - off:hi - off] = vf[:, rows].to(cv.dtype)
        j, slot = j + run, 0


def _seq_cached(rq: _RankQ, k, v, ck, cv, mp, variant: str, *,
                causal: bool, window: int, cache_len: int, mode: str,
                ring_window: int):
    """Attention with a cache leaf cut over its slots (`seq_cut`): the
    rank's columns of the output (B, S, c). Prefill attends the fresh
    tokens as under "heads" ("seqkv", a ring, or "shmap" when the ranks
    do not divide S: the reference's `:307-318`) or through
    `shmap_attention` ("shmap", a cache of positions, S divided: its
    `:311-314`), and writes the fresh K / V, gathered whole, into the
    rank's block. Decode gathers the token's q / k / v whole; the rank
    whose block holds slot cache_len (a ring's cache_len % W) writes the
    new K / V; `seq_decode_attention` attends."""
    s = k.shape[1]
    total = ck.shape[1] * mp.world
    if not ring_window and cache_len + s > total:
        raise ValueError(f"cache of {total} positions cannot take {s} more "
                         f"at {cache_len}")
    if mode == "prefill":
        if variant == "shmap" and not ring_window and s % mp.world == 0:
            out, kf, vf = _shmap_fresh(rq, k, v, mp, causal=causal,
                                       window=window,
                                       wire=SEQ_VARIANTS[variant])
        else:
            out = rq.own(_full_attention(rq.local(), k, v, causal=causal,
                                         window=ring_window or window),
                         False)
            kf, vf = _gather_heads(mp, rq.cfg, None, k, v)
        if ring_window:
            m = min(s, total)
            _write_block(ck, cv, kf, vf, s - m, s - m, mp)
        else:
            _write_block(ck, cv, kf, vf, 0, cache_len, mp)
        return out
    if s != 1:
        raise ValueError(f"sequence-cut decode writes one token, got {s}")
    qf, kf, vf = rq.whole(k, v)
    _write_block(ck, cv, kf, vf, 0, cache_len, mp)
    out = seq_decode_attention(qf, ck, cv, mp, cache_len=cache_len,
                               window=ring_window or window,
                               offset=mp.rank * ck.shape[1],
                               ring=bool(ring_window))
    return rq.own(out, True)


def attention(p, cfg, x, *, positions, causal: bool = True,
              window: int = NO_WINDOW, kv_cache: dict | None = None,
              cache_len: int | None = None, mode: str = "decode",
              ring_window: int = 0, cross_kv: tuple | None = None, mp=None):
    """Full attention op: projections + rope + (cached) attention + out proj.

    kv_cache: {"k","v"}: (B, S_max, Hkv, hd) written IN PLACE at the host
    int cache_len (or, with ring_window=W, a (B, W, Hkv, hd) ring buffer,
    slot = position % W), and "cut", its layout tag ("heads" or "seq";
    `seq_cut`). mode: "decode" attends q against the whole cache;
    "prefill" writes the fresh K/V into the cache but attends only against
    the fresh keys (the cache starts empty). cross_kv: an encoder's
    projected (k, v, cut), k and v (B, S_enc, Hkv, hd) and cut their
    layout tag, for encoder-decoder cross attention (`cross_attention`). The head counts
    are the weights': a rank's shard (its wq / wk / wv columns, wo rows)
    attends with its own heads, and `out` is then its partial sum of the
    output projection. Where the ranks split the query heads
    (`parallel.q_split`: its wq columns are a block of H·hd, not whole
    heads), the rank gathers q whole (one all-gather), attends the heads
    its columns touch (`parallel.q_heads`) over the kv heads it holds, and
    keeps its own columns of the output (`_RankQ`).

    mp with cfg.attn_shard "seqkv" / "shmap" (module docstring): with no
    cache, `shmap_attention` over the ranks' blocks of the keys when the
    ranks divide S (the reference's `:269-272`, `:325-327`), else as under
    "heads"; a cache leaf cut over its slots (`seq_cut`) goes through
    `_seq_cached`; a leaf cut over the kv heads (the "seq" rule's fallback)
    is attended as under "heads", but for a "shmap" prefill of a cache of
    positions, which takes `shmap_attention` as the reference does. In
    training "shmap" is differentiable as the reference's shard_map
    (`_gather_heads`, `parallel.combine_partials`).
    Returns (out, kv_cache)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"]
    if cross_kv is not None:
        return cross_attention(p, cfg, q.reshape(b, s, -1, hd), *cross_kv,
                               mp=mp), None
    hkv = p["wk"].shape[1] // hd
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)

    def prep(q):
        # whole on every rank, applied to the rank's heads: in training
        # their gradients are summed over the ranks
        if cfg.qk_norm:
            q = rms_norm(q, enter_partial(mp, p["q_norm"]))
        return apply_rope(q, cos, sin)

    rq = _RankQ(mp, cfg, q, prep)
    if cfg.qk_norm:
        k = rms_norm(k, enter_partial(mp, p["k_norm"]))
    k = apply_rope(k, cos, sin)
    variant = cfg.attn_shard if mp is not None else "auto"
    shmap = variant in SEQ_VARIANTS and s % mp.world == 0
    one = one_process_shape(cfg) if mp is None else None
    if kv_cache is None:
        if shmap:
            out = _shmap_fresh(rq, k, v, mp, causal=causal, window=window,
                               wire=SEQ_VARIANTS[variant])[0]
        elif one is not None and s % one[1] == 0:
            out = rq.own(blocked_attention(
                rq.local(), k, v, one[1], causal=causal, window=window,
                wire=SEQ_VARIANTS[cfg.attn_shard]), False)
        else:
            out = rq.own(_full_attention(rq.local(), k, v, causal=causal,
                                         window=window), False)
        return out @ p["wo"], None
    ck, cv = kv_cache["k"], kv_cache["v"]
    if seq_cut(mp, kv_cache["cut"]):
        out = _seq_cached(rq, k, v, ck, cv, mp, variant, causal=causal,
                          window=window, cache_len=cache_len, mode=mode,
                          ring_window=ring_window)
    elif ring_window:
        w = ring_window
        if mode == "prefill":
            out = _full_attention(rq.local(), k, v, causal=causal, window=w)
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
            out = decode_attention(rq.local(), ck, cv, q_offset=cache_len,
                                   window=w, ring=True)
        out = rq.own(out, False)
    else:
        if cache_len + s > ck.shape[1]:
            raise ValueError(f"cache of {ck.shape[1]} positions cannot take "
                             f"{s} more at {cache_len}")
        ck[:, cache_len:cache_len + s] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + s] = v.to(cv.dtype)
        if mode == "prefill" and shmap and variant == "shmap":
            out = _shmap_fresh(rq, k, v, mp, causal=causal, window=window,
                               wire=SEQ_VARIANTS[variant])[0]
        elif mode == "prefill":
            out = rq.own(_full_attention(rq.local(), k, v, causal=causal,
                                         window=window), False)
        else:
            out = rq.own(decode_attention(rq.local(), ck, cv,
                                          q_offset=cache_len, window=window),
                         False)
    return out @ p["wo"], kv_cache


def cross_attention(p, cfg, q, k, v, cut: str, mp=None) -> torch.Tensor:
    """Encoder-decoder cross attention of the projected queries q (B, Sq,
    H, hd) over an encoder's K/V (B, S_enc, Hkv, hd), through the out
    projection: no rope, q normed only under cfg.qk_norm (k never), no
    mask. Several queries take the full (or, past _BLOCKWISE_THRESHOLD
    keys, blockwise) attention; one query — a decode step over the cached
    cross K/V — runs K8 at cache_len S_enc - 1 with no window, which
    attends every encoder position. K8 accumulates P.V in float32 where
    the reference's dot attention first casts the probabilities to q's
    dtype: the same in float32, closer to exact in bfloat16. Under model
    parallelism q, k and v are the rank's heads and the output its partial
    sum of wo; where the cached cross K/V is cut over its frames (its tag
    `cut` "seq", `seq_cut`: every kv head, the rank's block of S_enc /
    world frames) the rank's query heads are gathered whole and K8's
    partials mode runs over its block, combined over the ranks in float32
    (`seq_decode_attention`: the reference's GSPMD reduction of its dot
    attention over a sharded S_enc), and the rank keeps its own heads."""
    b, s, h, hd = q.shape
    if cfg.qk_norm:
        q = rms_norm(q, enter_partial(mp, p["q_norm"]))
    if s == 1 and seq_cut(mp, cut):
        n = k.shape[1]
        qf, = _gather_heads(mp, cfg, q, None, None)
        out = seq_decode_attention(qf, k, v, mp,
                                   cache_len=n * mp.world - 1,
                                   offset=mp.rank * n)
        out = _own_cols(mp, cfg, out)
    elif s == 1:
        out = decode_attention(q, k, v, q_offset=k.shape[1] - 1)
    else:
        out = _full_attention(q, k, v, causal=False, window=NO_WINDOW)
    return out.reshape(b, s, h * hd) @ p["wo"]


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


# ---------------------------------------------------------------------------
# Mixture of Experts: capacity-based scatter dispatch (no giant one-hots)
# ---------------------------------------------------------------------------


# The pass of a block under remat (`zoo._remat`) that this thread runs, if
# any: [the forward's expert choices, whether this is the recompute, the
# next routing's index among them].
_REMAT_PASS = threading.local()


@contextlib.contextmanager
def remat_pass(routes: list, again: bool):
    """Within, on this thread: the forward (again False) or the recompute
    in the backward (again True) of one block under remat. `routes` holds
    the gate_i of each routing of the block's forward, in call order; the
    recompute's are held to them (`_route_held`)."""
    prev = getattr(_REMAT_PASS, "state", None)
    _REMAT_PASS.state = [routes, again, 0]
    try:
        yield
    finally:
        _REMAT_PASS.state = prev


def recomputing() -> bool:
    """Whether this thread runs the recompute of a block under remat (a
    recorder of the step's routings skips its calls: they repeat the
    forward's)."""
    state = getattr(_REMAT_PASS, "state", None)
    return state is not None and state[1]


def forward_route() -> torch.Tensor | None:
    """In the recompute of a block under remat, the gate_i that its
    forward took at the routing about to run (what a wrapper of
    `moe_route` that fed the forward its choices feeds again); else
    None."""
    state = getattr(_REMAT_PASS, "state", None)
    if state is None or not state[1]:
        return None
    return state[0][state[2]]


def _route_held(gate_i: torch.Tensor) -> None:
    """gate_i, the expert choices a routing of a block under remat took:
    kept in its forward; in its recompute held to the forward's, equal
    exactly (RuntimeError otherwise: the backward would take the
    gradients of other choices than the loss's). `meta` tensors carry no
    choices to compare."""
    state = getattr(_REMAT_PASS, "state", None)
    if state is None:
        return
    routes, again, at = state
    if not again:
        routes.append(gate_i)
        return
    state[2] = at + 1
    if not gate_i.is_meta and not torch.equal(routes[at], gate_i):
        raise RuntimeError(
            f"the recompute of a block under remat chose other experts "
            f"than its forward at routing {at}: "
            f"{int((routes[at] != gate_i).sum())} of {gate_i.numel()} "
            f"choices differ")


def moe_route(p, cfg, xt: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-choice routing of xt (T, d): (probs (T, E) float32, gate_v
    (T, k) the renormalised top-k probabilities, gate_i (T, k) int64).

    The router logits are taken in the weights' dtype and only then cast
    to float32, as in the reference. Its `jax.lax.top_k` puts the lower
    expert index first among equal probabilities, which `torch.topk` does
    not promise: the top k are the first k of a STABLE descending sort."""
    logits = (xt @ p["router"]).float()                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_v, gate_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_v, gate_i = gate_v[:, :cfg.top_k], gate_i[:, :cfg.top_k]
    gate_v = gate_v / torch.clamp_min(gate_v.sum(-1, keepdim=True), 1e-9)
    return probs, gate_v, gate_i


def moe_capacity(cfg, tokens: int) -> int:
    """Slots per expert for a call of `tokens` tokens (the reference's
    capacity-factor rule); choices past an expert's capacity are dropped."""
    return int(max(1, math.ceil(cfg.capacity_factor * tokens * cfg.top_k
                                / cfg.n_experts)))


def moe_positions(gate_i: torch.Tensor, n_experts: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """gate_i (T, k) -> (flat_e (T*k,), pos (T*k,)): each choice's expert
    and its position in that expert's buffer, a cumsum of one-hot
    memberships in token-major order (stable, no sort); a choice is kept
    iff pos < the capacity."""
    flat_e = gate_i.reshape(-1)
    onehot = F.one_hot(flat_e, n_experts)                      # (T*k, E)
    pos = torch.gather(torch.cumsum(onehot, dim=0) - 1, 1,
                       flat_e[:, None])[:, 0]
    return flat_e, pos


def _expert_mlps(p, buf: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU MLPs on their buffers buf (E, C, d): plain
    batched matmuls (the reference leaves them to XLA)."""
    hidden = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_in"])
    return torch.bmm(hidden, p["w_out"])                       # (E, C, d)


def _combine(gathered: torch.Tensor, keep: torch.Tensor,
             gate_v: torch.Tensor) -> torch.Tensor:
    """Each token's (T, d) gate-weighted sum of its k choices' outputs
    gathered (T * k, d), a dropped choice (keep False) adding zero."""
    t, k = gate_v.shape
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=gathered.device))
    return (gathered.reshape(t, k, -1)
            * gate_v.reshape(t, k, 1).to(gathered.dtype)).sum(dim=1)


def _switch_aux(probs: torch.Tensor, gate_i: torch.Tensor,
                e: int) -> torch.Tensor:
    """The Switch-transformer load-balance loss (float32)."""
    me = probs.mean(dim=0)                                     # (E,)
    ce = F.one_hot(gate_i[:, 0], e).float().mean(dim=0)
    return e * torch.sum(me * ce)


def moe_dispatch(cfg, probs: torch.Tensor, gate_i: torch.Tensor, mp=None):
    """Where each of the T * k choices of the tokens (probs (T, E), gate_i
    (T, k)) goes, and the Switch aux: (flat_e, pos, slot, cap, aux).
    flat_e and pos are `moe_positions` over these tokens; slot is each
    choice's position in its expert's buffer over the whole batch; a choice
    is kept iff slot < cap, the capacity of the whole batch.

    Without mp, or over one "data" rank, the tokens are the batch: slot is
    pos, cap `moe_capacity` of T, aux `_switch_aux`. Over several "data"
    ranks (each holding its rows of the batch, in order) the unsharded
    step's choices are made: cap counts every rank's tokens, a rank's slots
    follow the per-expert counts of the ranks before it (the token-major
    cumsum over the batch), and the aux takes the router probabilities'
    mean and the top-1 shares over the batch. One all-reduce over "data"
    carries the three (`parallel.sum_over`: the probabilities' gradient
    passes through to this rank's tokens)."""
    t, e = gate_i.shape[0], cfg.n_experts
    flat_e, pos = moe_positions(gate_i, e)
    if mp is None or mp.data_world == 1:
        return flat_e, pos, pos, moe_capacity(cfg, t), _switch_aux(
            probs, gate_i, e)
    n = mp.data_world
    counts = probs.new_zeros((n, e))
    counts[mp.data_rank] = F.one_hot(flat_e, e).sum(0).to(probs.dtype)
    top1 = F.one_hot(gate_i[:, 0], e).sum(0).to(probs.dtype)
    total = sum_over(mp, torch.cat([probs.sum(0), top1, counts.reshape(-1)]),
                     ("data",))
    before = total[2 * e:].view(n, e)[:mp.data_rank].sum(0).round().long()
    aux = e * torch.sum((total[:e] / (t * n)) * (total[e:2 * e] / (t * n)))
    return flat_e, pos, pos + before[flat_e], moe_capacity(cfg, t * n), aux


def _dispatch_rows(pos, slot, cap: int, t: int, k: int):
    """(keep, the buffer rows, each choice's row): a choice is kept iff
    its slot < cap and takes the row pos in its expert's buffer; a dropped
    one the spare row. The buffer holds cap rows when the tokens are the
    whole batch (slot is pos), else min(cap, T * k), enough for this
    rank's kept choices (pos <= slot < cap)."""
    keep = slot < cap
    rows = cap if slot is pos else min(cap, t * k)
    return keep, rows, torch.where(keep, pos, rows)


def moe_ffn(p, cfg, x: torch.Tensor, mp=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with capacity-factor scatter dispatch (the
    reference's `moe_ffn`, src/repro/models/layers.py).

    x: (B, S, d). Returns (out (B, S, d), aux) where aux is the Switch
    load-balance loss (float32). Every choice takes its position in its
    expert's buffer from a cumsum of one-hot memberships in token-major
    (T * k) order — the reference's order, not a sort; a choice at or past
    the capacity is dropped (its scatter lands in the spare row `cap`,
    which is sliced away). Under mp x is this "data" rank's rows of the
    batch and the choices are the whole batch's (`moe_dispatch`)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_v, gate_i = moe_route(p, cfg, xt)
    _route_held(gate_i)

    flat_e, pos, slot, cap, aux = moe_dispatch(cfg, probs, gate_i, mp)
    keep, rows, safe_pos = _dispatch_rows(pos, slot, cap, t, k)

    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = xt.new_zeros((e, rows + 1, d))
    buf = buf.index_put((flat_e, safe_pos), xt[tok_idx])
    out_buf = _expert_mlps(p, buf[:, :rows])                   # (E, C, d)

    # A dropped choice's index `cap` lies past the buffer's last row: the
    # reference's gather clamps it there and masks the value; indexing
    # raises in torch (a device-side assert on the card), so clamp it here
    # and mask the same way (no value, no gradient reaches that row).
    gathered = out_buf[flat_e, torch.clamp_max(safe_pos, rows - 1)]
    y = _combine(gathered, keep, gate_v)
    return y.reshape(b, s, d), aux


def _local_experts(p, cfg, xt, gate_v, gate_i, e0: int,
                   dispatch: tuple) -> torch.Tensor:
    """The (T, d) part of moe_ffn's output that experts e0 .. e0 + E_loc - 1
    make (p holds their w_gate / w_in / w_out (E_loc, ...)) for the routing
    (gate_v, gate_i) of the tokens xt (T, d) over all E experts, the
    choices placed by `dispatch` (`moe_dispatch`'s flat_e, pos, slot,
    cap). A choice takes moe_ffn's position in its expert's buffer, so
    each local expert's buffer is moe_ffn's; a choice of another rank's
    expert, or at or past the capacity, is dropped (its scatter lands in
    the spare row E_loc or column `rows`, both sliced away) and adds
    zero."""
    t, d = xt.shape
    e_loc = p["w_gate"].shape[0]
    flat_e, pos, slot, cap = dispatch
    keep, rows, _ = _dispatch_rows(pos, slot, cap, t, cfg.top_k)
    loc_e = flat_e - e0
    keep = (loc_e >= 0) & (loc_e < e_loc) & keep
    safe_e = torch.where(keep, loc_e, e_loc)                   # e_loc: dropped
    safe_pos = torch.where(keep, pos, rows)

    tok_idx = torch.arange(t, device=xt.device).repeat_interleave(cfg.top_k)
    buf = xt.new_zeros((e_loc + 1, rows + 1, d))
    buf = buf.index_put((safe_e, safe_pos), xt[tok_idx])
    out_buf = _expert_mlps(p, buf[:e_loc, :rows])              # (E_loc, C, d)

    # clamped into the buffer and masked, as moe_ffn's dropped choices
    gathered = out_buf[torch.clamp_max(safe_e, e_loc - 1),
                       torch.clamp_max(safe_pos, rows - 1)]
    return _combine(gathered, keep, gate_v)


def moe_ffn_shmap(p, cfg, x: torch.Tensor, mp, *,
                  wire: torch.dtype = torch.bfloat16
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE (the reference's `moe_ffn_shmap`): rank r holds
    experts r * E_loc .. (r + 1) * E_loc - 1 of w_gate / w_in / w_out
    (E_loc = E / world) and the whole router. The activations are whole on
    every rank, so each routes every token over all E experts exactly as
    `moe_ffn` does (the same capacity ceil(capacity_factor T k / E), the
    same positions), runs only its own experts (`_local_experts`), and one
    all-reduce of the (T, d) output sums the ranks' parts: no dispatch
    all-to-all. In training the tokens and their gates enter the rank's
    experts through `parallel.enter_partial` (their gradients summed over
    the ranks in the backward) and the sum passes its gradient through;
    the routing and the aux, the same on every rank, stay outside.

    The output crosses the wire in `wire`'s dtype and is returned in it:
    bfloat16 as the reference's `psum(y.astype(bfloat16))` (its "shmap"
    variant), or x's dtype for the plain "tp" layout, whose reference
    (GSPMD's partition of `moe_ffn`) casts nothing. aux: every rank routes
    every token, so each computes moe_ffn's aux; the reference's pmean of
    it runs over the data axes, which `moe_dispatch` stands for where the
    mesh has them (x is then this "data" rank's rows).

    Under cfg.attn_shard "shmap" the data axes take the reference's
    shard_map semantics (its `moe_ffn_shmap` `:463`, `:489-491`): the
    choices are made over this "data" rank's tokens alone (the capacity
    of its T tokens, its positions from its first token), and the aux is
    its tokens' Switch loss mean'd over the "data" ranks (one all-reduce,
    the gradient passed through, 1 / D of it to each); over one "data"
    rank the two are the same."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs, gate_v, gate_i = moe_route(p, cfg, xt)
    _route_held(gate_i)
    e_loc = p["w_gate"].shape[0]
    if e_loc * mp.world != cfg.n_experts:
        raise ValueError(f"{cfg.name}: {e_loc} experts on each of "
                         f"{mp.world} ranks, the config has "
                         f"{cfg.n_experts}")
    per_shard = cfg.attn_shard == "shmap"
    *dispatch, aux = moe_dispatch(cfg, probs, gate_i,
                                  None if per_shard else mp)
    if per_shard and mp.data_world > 1:
        aux = sum_over(mp, aux, ("data",)) / mp.data_world
    y = _local_experts(p, cfg, enter_partial(mp, xt),
                       enter_partial(mp, gate_v), gate_i, mp.rank * e_loc,
                       tuple(dispatch))
    y = reduce_partial(mp, y.to(wire))
    return y.reshape(b, s, d), aux


def moe_ffn_blocks(p, cfg, x: torch.Tensor, data: int, model: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """`moe_ffn_shmap` under "shmap" over a (data, model) mesh, in one
    process (`one_process_mesh`): the batch's rows cut into `data` shards
    (one where `data` does not divide them: the reference's shard_map then
    keeps the batch whole), each shard routed and dispatched over its own
    tokens (the capacity of its tokens, its positions from its first
    token); the experts in `model` groups of E / model, each group's
    output cast to bfloat16 and the groups summed in it, as the ranks'
    psum; the aux each shard's Switch loss, mean'd over the shards.
    Returns (out (B, S, d) bfloat16, aux)."""
    b, _, d = x.shape
    shards = data if b % data == 0 else 1
    e_loc = cfg.n_experts // model
    ys, aux = [], 0.0
    for xs in x.chunk(shards):
        xt = xs.reshape(-1, d)
        probs, gate_v, gate_i = moe_route(p, cfg, xt)
        _route_held(gate_i)
        *dispatch, shard_aux = moe_dispatch(cfg, probs, gate_i)
        parts = [_local_experts(
            {k: p[k][g * e_loc:(g + 1) * e_loc]
             for k in ("w_gate", "w_in", "w_out")}, cfg, xt, gate_v, gate_i,
            g * e_loc, tuple(dispatch)).to(torch.bfloat16)
            for g in range(model)]
        ys.append(functools.reduce(operator.add, parts).reshape(xs.shape))
        aux = aux + shard_aux
    return torch.cat(ys), aux / shards


# ---------------------------------------------------------------------------
# Mamba2 (SSD) mixer: the sequential recurrence and the chunked form, each
# with explicit (conv, ssm) state for decode. The reference runs both in
# XLA (`jax.lax.scan`); here the scan is a Python loop carrying the f32
# state, and each form keeps the reference's own casts.
# ---------------------------------------------------------------------------


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0). F.softplus returns x itself above
    its threshold of 20, which this does not."""
    return torch.logaddexp(x, x.new_zeros(()))


def _mamba_heads(p, cfg, mp) -> tuple[int, int, int]:
    """(d_inner, heads, first head) of the mixer's weights p: the whole
    model's, or under mp the rank's (its rows of out_proj; its heads are
    the rank's block of the whole model's)."""
    di = p["out_proj"].shape[0]
    nh = di // cfg.ssm_head_dim
    return di, nh, 0 if mp is None else mp.rank * nh


def _mamba_in(p, cfg, x, state, di: int, nh: int, mp=None):
    """The mixer's input projection and depthwise causal conv: (z, xc, Bc,
    Cc, dt, new conv state), for di channels and nh heads (a rank's, under
    model parallelism: in_proj holds its z, x and dt columns and B / C
    whole, conv_w / conv_b its x channels and B / C; `parallel
    .mamba_pieces`). The conv is the einsum "bskc,kc->bsc" over the
    windows of the input left-padded with zeros (or prefixed with the
    carried conv state), plus conv_b, then silu. In training under mp
    the whole input and the B / C pieces, which every rank computes the
    same and uses on its own heads, enter through `parallel
    .enter_partial` (their gradients summed over the ranks)."""
    n = cfg.ssm_state
    x = enter_partial(mp, x)
    in_proj = enter_partial(mp, p["in_proj"], (2 * di, 2 * n))
    conv_w = enter_partial(mp, p["conv_w"], (di, 2 * n))
    conv_b = enter_partial(mp, p["conv_b"], (di, 2 * n))
    z, xc, Bc, Cc, dt = torch.split(x @ in_proj, [di, di, n, n, nh],
                                    dim=-1)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)                 # (B,S,di+2n)
    kw = cfg.ssm_conv
    if state is not None:
        full = torch.cat([state["conv"], conv_in], dim=1)
    else:
        full = F.pad(conv_in, (0, 0, kw - 1, 0))
    windows = full.unfold(1, kw, 1)                           # (B,S,C,kw)
    conv = torch.einsum("bsck,kc->bsc", windows, conv_w) + conv_b
    xc, Bc, Cc = torch.split(F.silu(conv), [di, n, n], dim=-1)
    return z, xc, Bc, Cc, dt, full[:, -(kw - 1):]


def rms_norm_cut(x: torch.Tensor, gamma: torch.Tensor, mp, width: int,
                 eps: float = 1e-6) -> torch.Tensor:
    """`rms_norm` over a dim cut over the ranks of mp: x and gamma are the
    rank's part of a dim `width` wide. The float32 sum of squares of each
    rank's part, summed over the ranks (one all-reduce), over width is the
    mean; each rank scales its own part, so the gradient of its part of
    the sum is the ranks' summed (`parallel.reduce_shared`)."""
    x32 = x.float()
    var = reduce_shared(mp, (x32 * x32).sum(-1, keepdim=True)) / width
    return (x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


def _mamba_out(p, cfg, y, z, mp=None):
    """out_norm (an RMS norm over the whole d_inner: under mp over the
    ranks' parts, `rms_norm_cut`), the z gate and out_proj; under mp the
    product is the rank's partial sum."""
    b, s = y.shape[:2]
    y = y.reshape(b, s, -1)
    y = (rms_norm(y, p["out_norm"]) if mp is None else
         rms_norm_cut(y, p["out_norm"], mp, cfg.ssm_d_inner))
    return (y * F.silu(z)) @ p["out_proj"]


def _ssm_init(state, key, shape, device) -> torch.Tensor:
    return (state[key] if state is not None
            else torch.zeros(shape, dtype=torch.float32, device=device))


def _head_slices(p, h0: int, nh: int, mp=None):
    """dt_bias, A_log and D (whole leaves) at the heads h0 .. h0 + nh - 1
    (under mp in training through `parallel.enter_partial`: each rank
    uses its heads' entries, so the gradients sum over the ranks)."""
    return (enter_partial(mp, p[k])[h0:h0 + nh]
            for k in ("dt_bias", "A_log", "D"))


def mamba2_scan(p, cfg, x: torch.Tensor, state: dict | None = None,
                mp=None):
    """x: (B, S, d_model). Returns (y, new_state), state {"conv": (B,
    conv-1, di+2n), "ssm": (B, H, hd, N) f32}. softplus(dt + dt_bias) and
    the decay are taken in x's dtype, and cast to f32 only for the scan.
    Under mp (p the rank's shard, x whole) the rank runs its heads: its
    state is (B, conv-1, di / world + 2n) and (B, H / world, hd, N), and y
    its partial sum of out_proj."""
    b, s, _ = x.shape
    n, hdim = cfg.ssm_state, cfg.ssm_head_dim
    di, nh, h0 = _mamba_heads(p, cfg, mp)
    dt_bias, a_log, d_skip = _head_slices(p, h0, nh, mp)
    z, xc, Bc, Cc, dt, new_conv = _mamba_in(p, cfg, x, state, di, nh, mp)
    xh = xc.reshape(b, s, nh, hdim)
    dt = softplus(dt + dt_bias)                               # (B,S,nh)
    decay = torch.exp(-torch.exp(a_log) * dt)
    xdt = xh.float() * dt.float()[..., None]                  # dt_t x_t
    Bf, Cf, decf = Bc.float(), Cc.float(), decay.float()
    S_ = _ssm_init(state, "ssm", (b, nh, hdim, n), x.device)
    ys = []
    for t in range(s):
        S_ = torch.addcmul(xdt[:, t, :, :, None] * Bf[:, t, None, None, :],
                           S_, decf[:, t, :, None, None])
        ys.append(torch.einsum("bhpn,bn->bhp", S_, Cf[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype) + xh * d_skip[:, None]
    return _mamba_out(p, cfg, y, z, mp), {"conv": new_conv, "ssm": S_}


def mamba2_chunked(p, cfg, x: torch.Tensor, state: dict | None = None,
                   chunk: int = 128, mp=None):
    """The chunked SSD form of mamba2_scan (the Mamba2 paper's algorithm):
    within a chunk the recurrence is a masked decay-weighted matmul, and
    only the per-chunk states are carried. dt is cast to f32 after the
    softplus and the log-decay is taken in f32. The sequence is padded to
    whole chunks with zeros (decay 1, no input), so the final state is the
    unpadded one. mp: the rank's heads, as mamba2_scan."""
    b, s, _ = x.shape
    n, hdim = cfg.ssm_state, cfg.ssm_head_dim
    di, nh, h0 = _mamba_heads(p, cfg, mp)
    dt_bias, a_log, d_skip = _head_slices(p, h0, nh, mp)
    z, xc, Bc, Cc, dt, new_conv = _mamba_in(p, cfg, x, state, di, nh, mp)
    xh = xc.reshape(b, s, nh, hdim).float()
    dt = softplus(dt + dt_bias).float()                       # (B,S,nh)
    la = -torch.exp(a_log.float()) * dt                       # log a_t
    Bf, Cf = Bc.float(), Cc.float()
    pad = (-s) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bf, Cf, dt, la = (F.pad(a, (0, 0, 0, pad)) for a in (Bf, Cf, dt, la))
    nc = xh.shape[1] // chunk
    xh, Bf, Cf, dt, la = (a.reshape((b, nc, chunk) + a.shape[2:])
                          for a in (xh, Bf, Cf, dt, la))
    cum = torch.cumsum(la, dim=2)                             # log P_t
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    S_ = _ssm_init(state, "ssm", (b, nh, hdim, n), x.device)
    ys = []
    for c in range(nc):
        xh_c, B_c, C_c, dt_c, cum_c = (a[:, c] for a in (xh, Bf, Cf, dt, cum))
        # intra-chunk: M[t,i] = (C_t.B_i) dt_i exp(cum_t - cum_i), i <= t
        cb = torch.einsum("btn,bin->bti", C_c, B_c)           # (B,L,L)
        dh = cum_c.transpose(1, 2)                            # (B,nh,L)
        ratio = torch.exp(torch.clamp(dh[:, :, :, None] - dh[:, :, None, :],
                                      -60.0, 0.0))
        m = (cb[:, None] * dt_c.transpose(1, 2)[:, :, None, :]
             * ratio * causal)                                # (B,nh,L,L)
        y = torch.einsum("bhti,bihp->bthp", m, xh_c)
        # inter-chunk: the carried state's contribution
        y = y + torch.einsum("btn,bhpn->bthp", C_c,
                             S_) * torch.exp(cum_c)[..., None]
        # S_end = P_L S_prev + sum_i (P_L / P_i) dt_i B_i x_i
        w = torch.exp(torch.clamp(cum_c[:, -1:] - cum_c, min=-60.0)) * dt_c
        S_in = torch.einsum("bih,bin,bihp->bhpn", w, B_c, xh_c)
        S_ = S_ * torch.exp(cum_c[:, -1])[..., None, None] + S_in
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, nh, hdim)[:, :s]
    y = y.to(x.dtype) + xc.reshape(b, s, nh, hdim).to(x.dtype) \
        * d_skip[:, None]
    return _mamba_out(p, cfg, y, z, mp), {"conv": new_conv, "ssm": S_}


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): time-mix with data-dependent decay, and channel-mix
# ---------------------------------------------------------------------------


def _lora(x, A, B):          # low-rank adapter: x @ A @ B
    return (x @ A) @ B


def _token_shift(x, state):
    """(prev - x, new shift): prev is x one step back, its first row the
    carried shift (or zeros)."""
    if state is not None:
        prev = torch.cat([state["shift"][:, None], x[:, :-1]], dim=1)
    else:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    return prev - x, x[:, -1]


def _rwkv_heads(p, cfg, mp) -> tuple[int, int, int]:
    """(heads, head dim, first channel) of the time mix's weights p: the
    whole model's, or under mp the rank's (its columns of wr; its heads
    are the rank's block of the whole model's)."""
    hd = cfg.rwkv_head_dim
    dl = p["wr"].shape[1]
    return dl // hd, hd, 0 if mp is None else mp.rank * dl


def _rwkv6_mix(p, cfg, x, state, mp=None):
    """The time-mix's projections: (r, k, v (B,S,nh,hd) in x's dtype, g, log
    w (B,S,nh,hd) f32, new shift), with the data-dependent token shift.
    Under mp x and the shift are whole and the rank's wr / wk / wv / wg
    columns give its heads' r, k, v, g; w0 and the decay LoRA's output
    (whole leaves) are taken at its channels. In training the shifted
    inputs of those columns, the decay LoRA's hidden and the whole leaves
    taken at the rank's channels enter through `parallel.enter_partial`
    (every rank computes them the same; each uses them on its heads)."""
    b, s, _ = x.shape
    nh, hd, c0 = _rwkv_heads(p, cfg, mp)
    c1 = c0 + nh * hd
    dx, new_shift = _token_shift(x, state)

    def shifted(nm, lora):
        return x + dx * (p[f"mu_{nm}"] + _lora(x, p[f"{lora}_A"],
                                               p[f"{lora}_B"]))

    xr, xk, xv = shifted("r", "lr"), shifted("k", "lk"), shifted("v", "lv")
    xw, xg = shifted("w", "lw"), shifted("g", "lg")
    r = (enter_partial(mp, xr) @ p["wr"]).reshape(b, s, nh, hd)
    k = (enter_partial(mp, xk) @ p["wk"]).reshape(b, s, nh, hd)
    v = (enter_partial(mp, xv) @ p["wv"]).reshape(b, s, nh, hd)
    g = F.silu(enter_partial(mp, xg) @ p["wg"])
    hw = enter_partial(mp, xw @ p["ww_A"])               # the LoRA's hidden
    lw = -torch.exp((enter_partial(mp, p["w0"])[c0:c1]
                     + hw @ enter_partial(mp, p["ww_B"])[:, c0:c1]).float())
    return r, k, v, g, lw.reshape(b, s, nh, hd), new_shift


def _rwkv6_out(p, x, y, g, mp=None):
    """ln_x, an RMS norm over each head's hd channels of y (B,S,nh,hd)
    f32, then the gate and the output projection (under model parallelism
    the rank's heads and its partial sum of wo; ln_x, whole, enters
    through `parallel.enter_partial`)."""
    b, s = y.shape[:2]
    y = rms_norm(y, enter_partial(mp, p["ln_x"])).reshape(b, s, -1).to(
        x.dtype)
    return (y * g) @ p["wo"]


def rwkv6_timemix(p, cfg, x: torch.Tensor, state: dict | None = None,
                  mp=None):
    """x: (B, S, d). state: {"shift": (B, d), "wkv": (B, H, hd, hd) f32}.
    Each step reads y = r (S + u k^T v) before S = S w + k^T v. Under mp
    the rank runs its heads (wkv (B, H / world, hd, hd), the shift whole)
    and y is its partial sum of wo."""
    b, s, _ = x.shape
    nh, hd, c0 = _rwkv_heads(p, cfg, mp)
    r, k, v, g, lw, new_shift = _rwkv6_mix(p, cfg, x, state, mp)
    w = torch.exp(lw)                                         # in (0, 1)
    u = enter_partial(mp, p["u"])[c0:c0 + nh * hd].reshape(nh, hd)[
        None, :, :, None]
    rf, kf, vf = r.float(), k.float(), v.float()
    S_ = _ssm_init(state, "wkv", (b, nh, hd, hd), x.device)
    ys = []
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]     # (B,nh,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S_ + u * kv))
        S_ = torch.addcmul(kv, S_, w[:, t, :, :, None])
    y = torch.stack(ys, dim=1)                                # (B,S,nh,hd)
    return _rwkv6_out(p, x, y, g, mp), {"shift": new_shift, "wkv": S_}


def rwkv6_timemix_chunked(p, cfg, x: torch.Tensor, state: dict | None = None,
                          chunk: int = 32, mp=None):
    """The chunked-parallel form of rwkv6_timemix. Within a chunk
        y_t = r_t S_{t-1} + (r_t . u . k_t) v_t,
        A[t,i] = sum_c r_tc k_ic exp(cum_{t-1,c} - cum_{i,c})   (i < t),
    the exponent a partial sum of log-decays, so <= 0; the state carries
    across chunks as in the sequential form. r, k, v are cast to f32 here,
    and the sequence is padded to whole chunks with zeros (log-decay 0).
    mp: the rank's heads, as rwkv6_timemix."""
    b, s, _ = x.shape
    nh, hd, c0 = _rwkv_heads(p, cfg, mp)
    r, k, v, g, lw, new_shift = _rwkv6_mix(p, cfg, x, state, mp)
    r, k, v = r.float(), k.float(), v.float()
    u = enter_partial(mp, p["u"])[c0:c0 + nh * hd].reshape(nh, hd).float()
    pad = (-s) % chunk
    if pad:
        r, k, v, lw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, lw))
    nc = r.shape[1] // chunk
    r, k, v, lw = (a.reshape(b, nc, chunk, nh, hd) for a in (r, k, v, lw))
    cum = torch.cumsum(lw, dim=2)                             # inclusive
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device), diagonal=-1)   # i < t
    S_ = _ssm_init(state, "wkv", (b, nh, hd, hd), x.device)
    ys = []
    for c in range(nc):
        rt, kt, vt, ci, lwt = (a[:, c].transpose(1, 2)       # (B,nh,L,hd)
                               for a in (r, k, v, cum, lw))
        ct = ci - lwt                                         # cum_{t-1}
        ed = torch.exp(torch.clamp(ct[:, :, :, None, :] - ci[:, :, None, :, :],
                                   -60.0, 0.0))               # (B,nh,t,i,hd)
        A = torch.einsum("bhtc,bhic,bhtic->bhti", rt, kt, ed) * tri
        y = torch.einsum("bhti,bhiv->bhtv", A, vt)
        # the diagonal (bonus) term (r_t . u . k_t) v_t
        diag = torch.einsum("bhtc,hc,bhtc->bht", rt, u, kt)
        y = y + diag[..., None] * vt
        # inter-chunk: r_t . P_{t-1} applied to the carried state
        y = y + torch.einsum("bhtc,bhcv->bhtv", rt * torch.exp(ct), S_)
        # S = diag(P_L) S_prev + sum_i diag(P_L / P_i) k_i v_i^T
        wL = torch.exp(torch.clamp(ci[:, :, -1:] - ci, -60.0, 0.0))
        S_in = torch.einsum("bhic,bhiv->bhcv", kt * wL, vt)
        S_ = S_ * torch.exp(ci[:, :, -1])[..., None] + S_in
        ys.append(y.transpose(1, 2))                          # (B,L,nh,hd)
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, nh, hd)[:, :s]
    return _rwkv6_out(p, x, y, g, mp), {"shift": new_shift, "wkv": S_}


def rwkv6_channelmix(p, x: torch.Tensor, state: dict | None = None,
                     mp=None):
    """state: {"shift": (B, d)}. Under mp (x and the shift whole) the rank
    holds wk's columns and wv's rows of its ffn block and wr's columns of
    its channels: k @ wv is its partial sum, summed over the ranks (one
    all-reduce); the gate sigmoid(xr @ wr) covers its channels of that
    sum, and the gated channels are gathered whole (one all-gather). In
    training xk and xr enter through `parallel.enter_partial`, the sum's
    gradient is summed too (each rank uses its channels of it, `parallel
    .reduce_shared`) and the gather's is the rank's block."""
    dx, new_shift = _token_shift(x, state)
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    k = torch.square(F.relu(enter_partial(mp, xk) @ p["wk"]))
    kv = k @ p["wv"]
    gate = torch.sigmoid(enter_partial(mp, xr) @ p["wr"])
    if mp is None:
        return gate * kv, {"shift": new_shift}
    kv = reduce_shared(mp, kv)
    c0 = mp.rank * gate.shape[-1]
    out = gather_last(mp, gate * kv[..., c0:c0 + gate.shape[-1]])
    return out, {"shift": new_shift}
