"""Public wrappers of the port's kernels, with dispatch on the tensor's
device:

* a CPU tensor goes to the kernel's plain PyTorch version (`ref.py`);
* a CUDA tensor goes to the hand-written CUDA kernel (`csrc/*.cu`, built
  for sm_90a on first use), which raises if the card is not sm_90, the
  build fails or the launch fails. Nothing falls back from the kernel to
  the plain version.

Each kernel wrapper counts its launches (`launch_counts()`), so a run can
show that its hot path went through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.cascade_filter import kernel as _filter_kernel
from repro_torch.kernels.cascade_filter.ref import cascade_filter_ref
from repro_torch.kernels.cascade_score import kernel as _score_kernel
from repro_torch.kernels.cascade_score.ref import cascade_score_batched_ref

# name -> the wrapper that launches the kernel (and carries `.launches`)
KERNELS = {
    "cascade_score_batched": _score_kernel.cascade_score_batched,
    "cascade_filter": _filter_kernel.cascade_filter,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _require_ranks(op: str, **named) -> None:
    """One consistent ValueError for rank-mismatched wrapper inputs, raised
    at the public API instead of as a shape error from inside a kernel.
    Each kwarg maps a name to (array, expected_rank)."""
    bad = [f"{name} has rank {getattr(arr, 'ndim', None)} "
           f"(shape {tuple(getattr(arr, 'shape', ()))}), expected rank {want}"
           for name, (arr, want) in named.items()
           if getattr(arr, "ndim", None) != want]
    if bad:
        raise ValueError(f"{op}: rank-mismatched inputs: " + "; ".join(bad))


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def cascade_score_batched(x: torch.Tensor, w_eff: torch.Tensor,
                          zq: torch.Tensor) -> torch.Tensor:
    """Batched fused scorer: x (B, G, d) padded query groups, w_eff (T, d),
    zq (B, T) per-group biases -> (B, G, T) cumulative log pass-probs."""
    _require_ranks("cascade_score_batched",
                   x=(x, 3), w_eff=(w_eff, 2), zq=(zq, 2))
    if _on_cpu(x):
        return cascade_score_batched_ref(x, w_eff, zq)
    return _score_kernel.cascade_score_batched(x, w_eff, zq)


def cascade_filter(x: torch.Tensor, w_eff: torch.Tensor, zq: torch.Tensor,
                   mask: torch.Tensor, m_q: torch.Tensor
                   ) -> dict[str, torch.Tensor]:
    """Fused score+filter hard cascade: x (B, G, d), zq (B, T),
    mask (B, G), m_q (B,) -> dict(lp, survivors, expected_counts, n_keep).
    The serving hot path: one kernel launch per batch on the card."""
    _require_ranks("cascade_filter", x=(x, 3), w_eff=(w_eff, 2), zq=(zq, 2),
                   mask=(mask, 2), m_q=(m_q, 1))
    if _on_cpu(x):
        return cascade_filter_ref(x, w_eff, zq, mask, m_q)
    return _filter_kernel.cascade_filter(x, w_eff, zq, mask, m_q)


__all__ = ["KERNELS", "cascade_filter", "cascade_filter_ref",
           "cascade_score_batched", "cascade_score_batched_ref",
           "launch_counts", "load_library", "reset_launch_counts"]
