"""Public wrappers of the port's kernels, with dispatch on the tensor's
device:

* a CPU tensor goes to the kernel's plain PyTorch version (`ref.py`);
* a CUDA tensor goes to the hand-written CUDA kernel (`csrc/*.cu`, built
  for sm_90a on first use), which raises if the card is not sm_90, the
  build fails or the launch fails. Nothing falls back from the kernel to
  the plain version.

The differentiable ops (`cascade_score_batched`, `cascade_loss_fused`,
`cascade_score`) are `torch.autograd.Function`s whose forward and backward
dispatch the same way: on the card a forward kernel and a backward kernel
(K1 + K3, K4 + K5, K6's two), on the CPU the plain forward and the
closed-form backward. `cascade_score` (K6, one query group) also maps
under `torch.func.vmap` over query groups, one call (one launch each way
on the card) for the whole batch: the losses' score_fn seam takes it that
way, as the reference's losses take `jax.vmap` of its op.
`cascade_score_fm` (K7, the same function of feature-major items) is
forward only, as in the reference.

`swa_decode` (K8) is the one-token decode attention of the LLM engine; it
takes float32 or bfloat16 and is not differentiable (serving only).

`query_bias` is the serving cascade's per-query stage biases zq = q @
w_q.T + b, each row summed in a fixed order, so a request's bits do not
depend on the size of the chunk it is served in (a port-only kernel: the
reference computes zq in XLA). Serving only, not differentiable.

Each kernel wrapper counts its launches (`launch_counts()`), so a run can
show that its hot path went through the kernels.

A `meta` tensor (the cost report's trace, `launch/dryrun.py`) reaches a
kernel only through `swa_decode`: K8 is the one kernel on a traced step
(an LLM's decode), and on `meta` it launches nothing, counts no launch
and hands its work to the sink of `kernel_work_sink`. Every other kernel
wrapper raises a ValueError naming its kernel on a `meta` tensor.
"""

from __future__ import annotations

import contextlib
import contextvars
import operator
from typing import Callable

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import load_library
from repro_torch.kernels.cascade_filter import kernel as _filter_kernel
from repro_torch.kernels.cascade_filter.ref import cascade_filter_ref
from repro_torch.kernels.cascade_loss import kernel as _loss_kernel
from repro_torch.kernels.cascade_loss.ref import (cascade_loss_bwd_ref,
                                                  cascade_loss_ref)
from repro_torch.kernels.cascade_score import kernel as _score_kernel
from repro_torch.kernels.cascade_score.ref import (
    cascade_score_batched_bwd_ref, cascade_score_batched_ref,
    cascade_score_bwd_ref, cascade_score_ref)
from repro_torch.kernels.query_bias import kernel as _qb_kernel
from repro_torch.kernels.query_bias.ref import query_bias_ref
from repro_torch.kernels.swa_decode import kernel as _swa_kernel
from repro_torch.kernels.swa_decode.ref import NO_WINDOW, swa_decode_ref

# name -> the wrapper that launches the kernel (and carries `.launches`)
KERNELS = {
    "cascade_score_batched": _score_kernel.cascade_score_batched,
    "cascade_filter": _filter_kernel.cascade_filter,
    "cascade_score_batched_bwd": _score_kernel.cascade_score_batched_bwd,
    "cascade_loss": _loss_kernel.cascade_loss,
    "cascade_loss_bwd": _loss_kernel.cascade_loss_bwd,
    "swa_decode": _swa_kernel.swa_decode,
    "cascade_score": _score_kernel.cascade_score,
    "cascade_score_bwd": _score_kernel.cascade_score_bwd,
    "cascade_score_fm": _score_kernel.cascade_score_fm,
    "query_bias": _qb_kernel.query_bias,
}


def launch_counts() -> dict[str, int]:
    """Each kernel's launches so far, read under the lock the wrappers
    count under (`_build.count_launch`), so threads launching at the same
    time lose no count."""
    with _build.launch_lock:
        return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    with _build.launch_lock:
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


# The callable a traced step reports the work of a kernel on `meta`
# tensors to: fn(name, operations, reads, out), reads a list of (input
# tensor, bytes the kernel reads of it), out the tensor it returns.
_work_sink: contextvars.ContextVar[Callable | None] = contextvars.ContextVar(
    "kernel_work_sink", default=None)


@contextlib.contextmanager
def kernel_work_sink(fn: Callable):
    """Within the block, each kernel call on `meta` tensors in this
    context reports its work to fn (the cost report's counter)."""
    token = _work_sink.set(fn)
    try:
        yield fn
    finally:
        _work_sink.reset(token)


def swa_decode_work(b: int, h: int, hkv: int, hd: int, itemsize: int,
                    cache_len: int, window: int) -> tuple[int, int, int]:
    """K8's work on one call: (operations, bytes of K and V read, bytes of
    q read = bytes written). It visits n_valid = min(cache_len + 1,
    window) positions: 4 B H n_valid hd operations (q.k and p.v), and
    reads n_valid slots of K and of V for each kv head."""
    n_valid = min(cache_len + 1, window)
    return (4 * b * h * n_valid * hd, 2 * b * n_valid * hkv * hd * itemsize,
            b * h * hd * itemsize)


def _swa_decode_meta(q, k, v, cache_len, window) -> torch.Tensor:
    """K8 on `meta` tensors: the checks of the CUDA wrapper, an empty
    (B, H, hd) output in q's dtype, no launch; the work goes to the sink."""
    cache_len, window = operator.index(cache_len), operator.index(window)
    b, _, h, hkv, hd = _swa_kernel.check_args("swa_decode", q, k, v,
                                              cache_len, window)
    ops_, kv_bytes, q_bytes = swa_decode_work(b, h, hkv, hd,
                                              q.element_size(), cache_len,
                                              window)
    out = torch.empty((b, h, hd), dtype=q.dtype, device="meta")
    sink = _work_sink.get()
    if sink is not None:
        sink("swa_decode", ops_,
             [(q, q_bytes), (k, kv_bytes // 2), (v, kv_bytes // 2)], out)
    return out


class _ScoreBatched(torch.autograd.Function):
    """K1 forward, K3 backward; residuals (x, w_eff, zq), as the reference's
    custom VJP (src/repro/kernels/ops.py:82-98)."""

    @staticmethod
    def forward(ctx, x, w_eff, zq):
        ctx.save_for_backward(x, w_eff, zq)
        if _on_cpu(x):
            return cascade_score_batched_ref(x, w_eff, zq)
        return _score_kernel.cascade_score_batched(x, w_eff, zq)

    @staticmethod
    def backward(ctx, g):
        x, w_eff, zq = ctx.saved_tensors
        g = g.contiguous()          # slices of lp arrive as strided views
        if _on_cpu(x):
            return cascade_score_batched_bwd_ref(x, w_eff, zq, g)
        return _score_kernel.cascade_score_batched_bwd(x, w_eff, zq, g)


class _Score(torch.autograd.Function):
    """K6 forward and backward; residuals (x, w_eff, zq), as the
    reference's custom VJP (src/repro/kernels/ops.py:64-78). Takes one
    group, x (N, d) with zq (T,), or, from the vmap rule, B groups at once,
    x (B, N, d) with zq (B, T) or (T,)."""

    @staticmethod
    def forward(x, w_eff, zq):
        if _on_cpu(x):
            return cascade_score_ref(x, w_eff, zq)
        return _score_kernel.cascade_score(x, w_eff, zq)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, w_eff, zq = ctx.saved_tensors
        g = g.contiguous()
        if _on_cpu(x):
            return cascade_score_bwd_ref(x, w_eff, zq, g)
        return _score_kernel.cascade_score_bwd(x, w_eff, zq, g)

    @staticmethod
    def vmap(info, in_dims, x, w_eff, zq):
        """Mapped x with w_eff unmapped (the losses' and the reference's
        benches' case, zq mapped or not): one `apply` over the stacked
        groups, so one K6 launch each way on the card for the whole batch,
        as `jax.vmap` gives the reference's kernel a grid axis. Any other
        in_dims (a mapped w_eff, an unmapped x; no caller has them): one
        `apply` per group, stacked along dim 0."""
        x_dim, w_dim, zq_dim = in_dims
        if x_dim is not None and w_dim is None:
            x = x.movedim(x_dim, 0).contiguous()
            if zq_dim is not None:
                zq = zq.movedim(zq_dim, 0).contiguous()
            return _Score.apply(x, w_eff, zq), 0

        def group(a, dim, i):
            return a if dim is None else a.select(dim, i).contiguous()
        args = (x, w_eff, zq)
        return torch.stack([
            _Score.apply(*(group(a, dim, i) for a, dim in zip(args, in_dims)))
            for i in range(info.batch_size)]), 0


class _LossFused(torch.autograd.Function):
    """K4 forward, K5 backward. zq_pen takes the counts stream's gradient;
    its value is not read (it equals zq by contract)."""

    @staticmethod
    def forward(ctx, xc, w_eff, zq, zq_pen):
        ctx.save_for_backward(xc, w_eff, zq)
        if _on_cpu(xc):
            return cascade_loss_ref(xc, w_eff, zq)
        return _loss_kernel.cascade_loss(xc, w_eff, zq)

    @staticmethod
    def backward(ctx, g_ll, g_cost, g_cnt):
        xc, w_eff, zq = ctx.saved_tensors
        gs = (g_ll.contiguous(), g_cost.contiguous(), g_cnt.contiguous())
        if _on_cpu(xc):
            return cascade_loss_bwd_ref(xc, w_eff, zq, *gs)
        return _loss_kernel.cascade_loss_bwd(xc, w_eff, zq, *gs)


def cascade_score_batched(x: torch.Tensor, w_eff: torch.Tensor,
                          zq: torch.Tensor) -> torch.Tensor:
    """Batched fused scorer: x (B, G, d) padded query groups, w_eff (T, d),
    zq (B, T) per-group biases -> (B, G, T) cumulative log pass-probs.
    Differentiable in all three inputs (K3 on the card)."""
    _require_ranks("cascade_score_batched",
                   x=(x, 3), w_eff=(w_eff, 2), zq=(zq, 2))
    return _ScoreBatched.apply(x, w_eff, zq)


def cascade_score(x: torch.Tensor, w_eff: torch.Tensor,
                  zq: torch.Tensor) -> torch.Tensor:
    """Single-group fused scorer: x (N, d) items of one query, w_eff (T, d),
    zq (T,) -> (N, T) cumulative log pass-probs. Differentiable in all
    three inputs (K6's backward on the card); float32 or bfloat16 inputs,
    float32 out. `torch.func.vmap(lambda xb, zb: cascade_score(xb, w_eff,
    zb))(x, zq)` scores (B, N, d) groups in one call each way."""
    _require_ranks("cascade_score", x=(x, 2), w_eff=(w_eff, 2), zq=(zq, 1))
    return _Score.apply(x, w_eff, zq)


def cascade_score_fm(xt: torch.Tensor, w_eff: torch.Tensor,
                     zq: torch.Tensor) -> torch.Tensor:
    """Feature-major fused scorer: xt (d, N) -> (N, T), the function of
    `cascade_score` on xt.T (K7 on the card, which has no backward, as
    in the reference)."""
    _require_ranks("cascade_score_fm", xt=(xt, 2), w_eff=(w_eff, 2),
                   zq=(zq, 1))
    if _on_cpu(xt):
        return cascade_score_ref(xt.T, w_eff, zq)
    return _score_kernel.cascade_score_fm(xt, w_eff, zq)


def cascade_loss_fused(xc: torch.Tensor, w_eff: torch.Tensor,
                       zq: torch.Tensor, zq_pen: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused L3 training-step reductions: xc (B, G, d_x+4) packed items
    ([x | y | mask | wgt | cost_w], `cascade_loss.kernel.pack_items`),
    w_eff (T, d_x), zq (B, T) -> (ll (B,), cost_pp (T,), cnt_pp (B, T)):
    the per-group NLL partials (Eqs 4/17), the Eq-8 expected-cost
    accumulators and the Eq-10 expected keep counts, from one pass over the
    items (K4 on the card).

    zq_pen MUST equal zq in value (the same query bias with the Eq-15
    stop-gradients applied): the forward does not read it, and the backward
    (K5 on the card) sends the counts stream to zq_pen only and the NLL and
    cost streams to w_eff and zq. With zq_pen=None, zq takes both, so the
    two gradients add up in zq. The y/mask/wgt/cost_w columns are data: the
    gradient in them is zero."""
    _require_ranks("cascade_loss_fused", xc=(xc, 3), w_eff=(w_eff, 2),
                   zq=(zq, 2),
                   **({} if zq_pen is None else {"zq_pen": (zq_pen, 2)}))
    return _LossFused.apply(xc, w_eff, zq, zq if zq_pen is None else zq_pen)


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


def swa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cache_len: int, *, window: int = NO_WINDOW) -> torch.Tensor:
    """Flash-decode attention of one token against a (sliding-window) KV
    cache: q (B, H, hd), k/v (B, S, Hkv, hd), the host int cache_len (the
    query's position) -> (B, H, hd) over the positions
    (cache_len - window, cache_len] (K8 on the card; on `meta` tensors
    no launch, its work reported to `kernel_work_sink`'s sink)."""
    _require_ranks("swa_decode", q=(q, 3), k=(k, 4), v=(v, 4))
    if _on_cpu(q):
        return swa_decode_ref(q, k, v, cache_len, window)
    if q.device.type == "meta":
        return _swa_decode_meta(q, k, v, cache_len, window)
    return _swa_kernel.swa_decode(q, k, v, cache_len, window)


def query_bias(q: torch.Tensor, w_q: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Per-query stage biases: q (R, d_q), w_q (T, d_q), b (T,) -> zq (R, T)
    = b + q @ w_q.T, each row summed over d_q in index order, so its bits
    depend on that row alone (the CUDA kernel on the card, its plain
    version on the CPU; the two give the same bits)."""
    _require_ranks("query_bias", q=(q, 2), w_q=(w_q, 2), b=(b, 1))
    if _on_cpu(q):
        return query_bias_ref(q, w_q, b)
    return _qb_kernel.query_bias(q, w_q, b)


__all__ = ["KERNELS", "NO_WINDOW", "cascade_filter", "cascade_filter_ref",
           "cascade_loss_bwd_ref", "cascade_loss_fused", "cascade_loss_ref",
           "cascade_score", "cascade_score_batched",
           "cascade_score_batched_bwd_ref", "cascade_score_batched_ref",
           "cascade_score_bwd_ref", "cascade_score_fm", "cascade_score_ref",
           "launch_counts", "load_library", "query_bias", "query_bias_ref",
           "reset_launch_counts", "swa_decode", "swa_decode_ref",
           "swa_decode_work"]
