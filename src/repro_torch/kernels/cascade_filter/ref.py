"""Plain PyTorch version of the fused cascade filter (K2), and the margin
check that guards every exact comparison of its discrete outputs.

Semantics (those of the CUDA kernel, `csrc/cascade_filter.cu`):

    lp[i, j]    = sum_{k<=j} log sigmoid(x[i] . w_eff[k] + zq[k])
    counts[j]   = (M_q / N_q) * sum_{i valid} exp(lp[i, j])          (Eq 10)
    n_keep[j]   = clip(ceil(counts[j] * N_q / max(M_q, 1)), 1, G)
    surv_j      = top-n_keep[j] of surv_{j-1} by lp[., j], STABLE
                  descending order (ties keep the lowest index)

The keep counts and the stage chain are core.pipeline's
keep_counts_from_lp / filter_chain, imported rather than copied. The chain
there is a stable double argsort, so the kernel's threshold select and this
version are two independent formulations of the selection; the select
itself is also written out here in plain code (threshold_select), for the
tests that hold it to the all-pairs rank.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cascade_score.ref import cascade_score_batched_ref

# Two float32 implementations of the same sums differ in the last bits, so
# an exact comparison of n_keep / survivors is only meaningful when no
# decision sits that close to its boundary:
CEIL_MARGIN = 1e-4      # a pre-ceil keep count this close to an integer ...
CEIL_REL_MARGIN = 1e-5  # ... or this close relative to its size flips
TIE_MARGIN = 1e-5       # two distinct scores this close at a cut may swap


def cascade_filter_ref(x: torch.Tensor, w_eff: torch.Tensor,
                       zq: torch.Tensor, mask: torch.Tensor,
                       m_q: torch.Tensor) -> dict[str, torch.Tensor]:
    """x: (B, G, d), w_eff: (T, d), zq: (B, T), mask: (B, G), m_q: (B,).

    Returns the same dict as kernel.cascade_filter.
    """
    # local import: kernels.ops -> this module; core.pipeline -> kernels.ops
    from repro_torch.core.pipeline import filter_chain, keep_counts_from_lp
    lp = cascade_score_batched_ref(x, w_eff, zq)
    counts, n_keep = keep_counts_from_lp(lp, mask, m_q)
    return {
        "lp": lp,
        "survivors": filter_chain(lp, mask, n_keep),
        "expected_counts": counts,
        "n_keep": n_keep,
    }


def order_key(s: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's order-preserving uint32 key of float32 scores (as
    int64): for floats that are not NaN, a > b iff key(a) > key(b), and
    a == b iff the keys are equal (-0.0 and +0.0 share one key)."""
    s = torch.where(s == 0, torch.zeros_like(s), s).float().contiguous()
    u = s.view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def _select_group(s: torch.Tensor, n_keep: int) -> torch.Tensor:
    """threshold_select for one group: s (G,) -> keep (G,)."""
    nan = torch.isnan(s)
    key = torch.where(nan, torch.zeros_like(s, dtype=torch.long),
                      order_key(s))                  # real keys are > 0
    kstar, above, cut = 0, 0, None
    for r in range(4):
        shift = 24 - 8 * r
        match = ~nan
        if r:
            match = match & ((key >> (shift + 8)) == (kstar >> (shift + 8)))
        hist = torch.zeros(256, dtype=torch.long).scatter_add_(
            0, (key >> shift) & 255, match.long())
        ge = hist.flip(0).cumsum(0).flip(0)              # #{digit >= b}
        need = n_keep - above
        hit = ((ge - hist < need) & (need <= ge)).nonzero()
        if not len(hit):            # fewer keys than n_keep: all stay
            kstar, cut = 0, 24
            break
        digit = int(hit[0])
        skipped = int(ge[digit] - hist[digit])
        kstar |= digit << shift
        above += skipped
        if skipped + int(hist[digit]) == need:   # the bin completes it
            cut = shift
            break
    if cut is not None:
        return nan | (~nan & ((key >> cut) >= (kstar >> cut)))
    gt = ~nan & (key > kstar)
    eq = ~nan & (key == kstar)
    before = torch.cumsum(eq.long(), 0) - eq.long()
    return nan | gt | (eq & (before < n_keep - above))


def threshold_select(s: torch.Tensor, n_keep: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's stable top-n_keep of one stage, as it computes it:
    s (B, G) scores (non-survivors at -inf), n_keep (B,) -> keep (B, G).

    v* is the n_keep-th largest key, found one 8-bit digit a round from
    the top: a histogram of the digits of the keys that share v*'s digits
    so far, and the digit b at which the keys known to exceed v* (`above`)
    plus those of digits > b stay below n_keep while those of digits >= b
    reach it. Where they reach it exactly, every key of digit b stays and
    the select ends; else, after the last digit, an item is kept iff its
    key exceeds v*, or equals it with fewer than n_keep - #{key > v*} equal
    keys before it. NaN scores take no part and are kept. Plain code for
    the tests, which hold it to the all-pairs rank."""
    return torch.stack([_select_group(row, int(k))
                        for row, k in zip(s, n_keep)])


def threshold_chain(lp: torch.Tensor, mask: torch.Tensor,
                    n_keep: torch.Tensor) -> torch.Tensor:
    """core.pipeline.filter_chain's stage chain as the CUDA kernel runs it:
    lp (B, G, T), mask (B, G), n_keep (B, T) -> survivors (B, G, T). A
    stage keeps every survivor without a select when n_keep >= G, or when
    n_keep >= the survivors and none of them scores -inf."""
    g = lp.shape[1]
    surv = mask.float()
    cols = []
    for j in range(lp.shape[-1]):
        alive = surv > 0
        s = torch.where(alive, lp[..., j], -torch.inf)
        nk = n_keep[:, j]
        shortcut = (nk >= g) | ((nk >= alive.sum(-1))
                                & ~(alive & (s == -torch.inf)).any(-1))
        keep = shortcut[:, None] | threshold_select(s, nk)
        surv = torch.where(alive, surv * keep.float(), surv)
        cols.append(surv)
    return torch.stack(cols, dim=-1)


def assert_decision_margin(lp: torch.Tensor, mask: torch.Tensor,
                           m_q: torch.Tensor) -> None:
    """Raise AssertionError unless every discrete decision the filter
    takes on these scores has margin: no pre-ceil keep count within
    max(CEIL_MARGIN, CEIL_REL_MARGIN * value) of flipping its clipped ceil,
    and at every stage's cut the last kept and the first dropped survivor
    either tie exactly (the stable tie-break then decides the same way in
    every implementation) or differ by more than TIE_MARGIN.

    lp (B, G, T) are the scores of the implementation taken as oracle;
    the check runs in float64 on the CPU."""
    lp = lp.detach().double().cpu()
    maskf = mask.detach().double().cpu()
    m = m_q.detach().double().cpu()
    b, g, t = lp.shape
    n = maskf.sum(-1)
    total = (lp.exp() * maskf[..., None]).sum(-2)                  # (B, T)
    pre = ((m / n.clamp_min(1.0))[:, None] * total
           * n[:, None] / m.clamp_min(1.0)[:, None])
    eps = torch.clamp_min(CEIL_REL_MARGIN * pre.abs(), CEIL_MARGIN)
    lo = torch.clamp(torch.ceil(pre - eps), 1.0, float(g))
    hi = torch.clamp(torch.ceil(pre + eps), 1.0, float(g))
    bad = (lo != hi).nonzero().tolist()
    if bad:
        vals = [float(pre[i, j]) for i, j in bad[:5]]
        raise AssertionError(
            f"no keep-count margin: pre-ceil values {vals} at (group, "
            f"stage) {bad[:5]} lie within the margin of an integer")
    n_keep = lo.long()
    surv = maskf > 0
    rows = torch.arange(b)
    for j in range(t):
        s = torch.where(surv, lp[..., j], torch.tensor(-torch.inf,
                                                       dtype=lp.dtype))
        srt, idx = torch.sort(s, dim=-1, descending=True, stable=True)
        nk = n_keep[:, j]
        cut = (nk < surv.sum(-1)).nonzero().flatten()
        if len(cut):
            gap = srt[cut, nk[cut] - 1] - srt[cut, nk[cut]]
            near = cut[(gap != 0) & (gap <= TIE_MARGIN)].tolist()
            if near:
                raise AssertionError(
                    f"no tie margin at stage {j}: groups {near[:5]} have "
                    f"two scores within {TIE_MARGIN} at the cut")
        rank = torch.empty_like(idx)
        rank[rows[:, None], idx] = torch.arange(g).expand(b, g)
        surv = surv & (rank < nk[:, None])
