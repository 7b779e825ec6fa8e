#!/usr/bin/env python3
"""Controls of chip_smoke.py's [fsdp lm] and [tp families train] checks on
one CUDA card: what a planted fault does to what they read, and how far
each split of the step alone moves the losses.

    python3 fsdp_controls.py [GROUP ...]

GROUP names a group of runs of CONTROLS ("faults", "splits", "model
split", "families", "shmap"); with none, every group runs.

[fsdp lm]'s run (FSDP_LM_ARCH at FSDP_LM_LAYERS layers, published widths,
float32 weights from seed 0, LM_TRAIN_STEPS Adam steps of the launcher's
batch; `launch.train.train_lm_rank` on ranks sharing the card) against
the launcher's unsharded run of the same steps, at two learning rates:

* FSDP_LM_LR, "fsdp" over FSDP_MESH with a fault planted in every rank:
  "no data sum" (`parallel.reduce_replicated_grads` skipped: the leaves
  left whole over "data", the norms, step on this data rank's rows only)
  and "half the rows" (data rank 1's NLL enters the loss's sum over
  "data" detached: the step descends on data rank 0's rows alone, the
  loss read is still the whole batch's);
* the launcher's lr 0.01, where the loss nearly doubles by the third
  step: "tp" over 1 x 2 (the model split alone), "zero3" over FSDP_MESH
  (the data split alone: it computes each data rank's rows whole) and
  "fsdp" over FSDP_MESH (both).

[tp families train]'s zamba2-1.2b run (FAMILY_TRAIN_ARCHS' depth and form,
"tp" over FAMILY_TRAIN_MESH at FAMILY_TRAIN_LR) with "raw norm sum"
planted: Mamba2's out_norm sums its squares over the ranks through the
raw all-reduce (`layers.rms_norm_cut` as it was before its autograd
form), so the sum's gradient is this rank's part alone.

[shmap train lm]'s run (SHMAP_LM_ARCH at SHMAP_LM_LAYERS layers, "tp" +
"shmap" over 1 x QSPLIT_WORLD at FSDP_LM_LR) against the one-process run
of the same semantics (`chip_smoke.shmap_lm_reference`), sound and with
each of SHMAP_FAULTS planted: "no kv sum" (`parallel.sum_held_kv`
skipped: a kv head's two holders step on their own parts of its
gradient), "no gather sum" (the q / k / v gathered whole enter with no
sum of their gradients over the ranks: each rank's q columns step on
its own heads' part alone) and "max carries gradient" (the combine's
scale keeps m's gradient, the plain softmax's exact gradient instead of
the reference's), held at [shmap train lm]'s bars.

Prints the card's name and power limit and per run the losses, their
largest relative difference from the unsharded run against LM_TRAIN_RTOL
(for the "shmap" group: step 1's absolute difference against
FSDP_LOSS_TOL and every step's against SHMAP_LM_BAR), and whether the
ranks sharing a leaf's pieces hold equal bits of it
(`chip_smoke.shared_bits`); a JSON summary as the last line. Exits
nonzero without a card.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

# two ranks of the unsharded step's half each fill most of the card;
# segments that grow keep the allocator's free blocks from splitting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import chip_smoke as CS  # noqa: E402
import torch  # noqa: E402

from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks, train_mesh  # noqa: E402
from repro_torch.models import layers as Lyr  # noqa: E402
from repro_torch.models import zoo as Z  # noqa: E402
from repro_torch.models.parallel import reduce_shared  # noqa: E402

LAUNCHER_LR = 0.01
FAULTS = ("no data sum", "half the rows")
SHMAP_FAULTS = (None, "no kv sum", "no gather sum", "max carries gradient")
# the runs: (arch, layers, ssm_impl, attn_shard)
FSDP_RUN = (CS.FSDP_LM_ARCH, CS.FSDP_LM_LAYERS, None, None)
NORM_RUN = ("zamba2-1.2b", CS.FAMILY_TRAIN_ARCHS["zamba2-1.2b"][1],
            CS.FAMILY_TRAIN_ARCHS["zamba2-1.2b"][0], None)
SHMAP_RUN = (CS.SHMAP_LM_ARCH, CS.SHMAP_LM_LAYERS, None, "shmap")
SHMAP_MESH = (1, CS.QSPLIT_WORLD)
# group -> (mesh, [(run, mode, lr, fault)]): one spawn each
CONTROLS = {
    "faults": (CS.FSDP_MESH, [(FSDP_RUN, "fsdp", CS.FSDP_LM_LR, f)
                              for f in FAULTS]),
    "splits": (CS.FSDP_MESH, [(FSDP_RUN, "zero3", LAUNCHER_LR, None),
                              (FSDP_RUN, "fsdp", LAUNCHER_LR, None)]),
    "model split": ((1, 2), [(FSDP_RUN, "tp", LAUNCHER_LR, None)]),
    "families": (CS.FAMILY_TRAIN_MESH, [(NORM_RUN, "tp", CS.FAMILY_TRAIN_LR,
                                         "raw norm sum")]),
    "shmap": (SHMAP_MESH, [(SHMAP_RUN, "tp", CS.FSDP_LM_LR, f)
                           for f in SHMAP_FAULTS]),
}


def raw_norm_sum(x, gamma, mp, width: int, eps: float = 1e-6):
    """`layers.rms_norm_cut` through the raw all-reduce (no autograd form:
    the backward takes this rank's part of the sum's gradient alone)."""
    x32 = x.float()
    var = mp.all_reduce_sum((x32 * x32).sum(-1, keepdim=True)) / width
    return (x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


def gather_unsummed(mp, cfg, q, k, v):
    """`layers._gather_heads` with no sum over the ranks of the gathered
    tensors' gradient (its `enter_partial` an identity)."""
    saved = Lyr.enter_partial
    Lyr.enter_partial = lambda mp_, x, piece=None: x
    try:
        return _GATHER_HEADS(mp, cfg, q, k, v)
    finally:
        Lyr.enter_partial = saved


def combine_with_max_gradient(mp, m, l, acc, wire):
    """`parallel.combine_partials` over the ranks (a training forward)
    with m's gradient kept through the scale exp(m - M): the unsharded
    softmax's gradient, not the reference's."""
    big = mp.all_reduce_max(m.detach().clone())
    scale = torch.where(torch.isfinite(m), torch.exp(m - big), 0.0)
    l = reduce_shared(mp, l * scale)
    acc = reduce_shared(mp, (acc * scale[..., None]).to(wire)).float()
    return acc / torch.clamp(l, min=1e-30)[..., None]


_GATHER_HEADS = Lyr._gather_heads


@contextlib.contextmanager
def planted(fault: str | None):
    """`zoo` and `layers` with `fault` planted while inside (module
    docstring)."""
    saved = (Z.reduce_replicated_grads, Z.sum_over, Lyr.rms_norm_cut,
             Z.sum_held_kv, Lyr._gather_heads, Lyr.combine_partials)
    if fault == "no data sum":
        Z.reduce_replicated_grads = lambda mp, grads, specs: grads
    elif fault == "half the rows":
        def sum_over(mp, x, axes):
            if axes == ("data",) and mp.data_rank == 1:
                x = x.detach() + 0 * x
            return saved[1](mp, x, axes)
        Z.sum_over = sum_over
    elif fault == "raw norm sum":
        Lyr.rms_norm_cut = raw_norm_sum
    elif fault == "no kv sum":
        Z.sum_held_kv = lambda mp, cfg, *grads: list(grads)
    elif fault == "no gather sum":
        Lyr._gather_heads = gather_unsummed
    elif fault == "max carries gradient":
        Lyr.combine_partials = combine_with_max_gradient
    try:
        yield
    finally:
        (Z.reduce_replicated_grads, Z.sum_over, Lyr.rms_norm_cut,
         Z.sum_held_kv, Lyr._gather_heads, Lyr.combine_partials) = saved


def control_rank(mp, runs: list) -> list[dict]:
    """One rank: `train_lm_rank` of each (run, mode, lr, fault) of `runs`,
    the fault planted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for (arch, layers, impl, shard), mode, lr, fault in runs:
        CS.free_cuda()
        with planted(fault):
            out.append(TLT.train_lm_rank(
                mp, arch, layers, mode, CS.LM_TRAIN_STEPS, CS.LM_TRAIN_BATCH,
                CS.LM_TRAIN_SEQ, 0, False, lr, impl, shard))
    return out


def unsharded(run, lr: float) -> list[float]:
    """The launcher's unsharded steps (`launch.train.lm_train_steps`) of
    the run's config at lr; for a "shmap" run, in one process with its
    ranks' semantics (`chip_smoke.shmap_lm_reference`)."""
    arch, layers, impl, shard = run
    cfg = TLT.lm_config(arch, False, layers, impl, shard)
    if shard == "shmap":
        assert lr == CS.FSDP_LM_LR, lr
        return CS.shmap_lm_reference(cfg)[0]
    with contextlib.redirect_stdout(io.StringIO()):
        losses = TLT.lm_train_steps(
            cfg, CS.LM_TRAIN_STEPS, CS.LM_TRAIN_BATCH, CS.LM_TRAIN_SEQ, 0, lr,
            "cuda")
    CS.free_cuda()
    return losses


def bars_met(run, got: list[float], want: list[float]) -> bool:
    """Whether one rank's losses meet the chip_smoke phase's bars: [shmap
    train lm]'s for a "shmap" run, else LM_TRAIN_RTOL of each loss."""
    if run[3] == "shmap":
        return (abs(got[0] - want[0]) <= CS.FSDP_LOSS_TOL * (1 + abs(want[0]))
                and max(abs(a - c) for a, c in zip(got, want))
                <= CS.SHMAP_LM_BAR)
    return max(abs(a - c) / abs(c) for a, c in zip(got, want)) \
        <= CS.LM_TRAIN_RTOL


def main(argv: list[str] | None = None) -> None:
    groups = argv if argv is not None else sys.argv[1:]
    unknown = set(groups) - set(CONTROLS)
    if unknown:
        raise SystemExit(f"fsdp_controls: unknown groups {sorted(unknown)}, "
                         f"expected some of {list(CONTROLS)}")
    groups = groups or list(CONTROLS)
    if not torch.cuda.is_available():
        raise SystemExit("fsdp_controls: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    want = {}
    for group in groups:
        for run, _, lr, _ in CONTROLS[group][1]:
            if (run, lr) not in want:
                want[run, lr] = unsharded(run, lr)
                print(f"[controls] {run[0]} ({run[1]} layers, attn_shard "
                      f"{run[3]}), unsharded, lr {lr}: losses "
                      f"{want[run, lr]}")
    summary = {"card": card, "runs": []}
    for group in groups:
        shape, runs = CONTROLS[group]
        ranks = spawn_ranks(shape[0] * shape[1], control_rank, (runs,),
                            device="cuda", timeout_s=1200,
                            mesh=train_mesh(*shape))
        for i, (run, mode, lr, fault) in enumerate(runs):
            cfg = TLT.lm_config(run[0], False, *run[1:])
            got = [rank[i] for rank in ranks]
            rel = [max(abs(a - c) / abs(c) for a in step) for step, c in
                   zip(zip(*(r["losses"] for r in got)), want[run, lr])]
            diff = [max(abs(a - c) for a in step) for step, c in
                    zip(zip(*(r["losses"] for r in got)), want[run, lr])]
            shared, differ = CS.shared_bits(cfg, train_mesh(*shape), mode,
                                            got)
            row = dict(arch=cfg.name, layers=cfg.n_layers,
                       ssm_impl=cfg.ssm_impl, attn_shard=cfg.attn_shard,
                       mode=mode, mesh=list(shape), lr=lr, fault=fault,
                       unsharded=want[run, lr],
                       losses=[r["losses"] for r in got], rel=rel, abs=diff,
                       loss_bar_met=all(bars_met(run, r["losses"],
                                                 want[run, lr]) for r in got),
                       shared_leaves=shared, shared_bits_equal=not differ)
            bars = (f"absolute difference a step "
                    f"{[float(f'{d:.3g}') for d in diff]} (bars "
                    f"{CS.FSDP_LOSS_TOL} at step 1, {CS.SHMAP_LM_BAR}"
                    if run[3] == "shmap" else
                    f"relative difference a step "
                    f"{[float(f'{r:.3g}') for r in rel]} (bar "
                    f"{CS.LM_TRAIN_RTOL}")
            print(f"[controls] {cfg.name} ({cfg.n_layers} layers, attn_shard "
                  f"{cfg.attn_shard}) {mode} over"
                  f" {shape[0]} x {shape[1]}, lr {lr},"
                  f" fault {fault}: losses {got[0]['losses']}, {bars}: "
                  f"{'met' if row['loss_bar_met'] else 'missed'}); ranks "
                  f"sharing a piece of {shared} leaves hold "
                  f"{'equal' if not differ else 'different'} bits"
                  + (f" ({len(differ)} mismatches)" if differ else ""))
            summary["runs"].append(row)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
