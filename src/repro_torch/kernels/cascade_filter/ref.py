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
there is a stable double argsort, so the kernel's all-pairs rank and this
version are two independent formulations of the selection.
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
