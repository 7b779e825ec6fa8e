#!/usr/bin/env python3
"""Controls of chip_smoke.py's [fsdp lm] and [tp families train] checks on
one CUDA card: what a planted fault does to what they read, and how far
each split of the step alone moves the losses.

    python3 fsdp_controls.py [GROUP ...]

GROUP names a group of runs of CONTROLS ("faults", "splits", "model
split", "families"); with none, every group runs.

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

Prints the card's name and power limit and per run the losses, their
largest relative difference from the unsharded run against LM_TRAIN_RTOL,
and whether the ranks sharing a leaf's pieces hold equal bits of it
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

LAUNCHER_LR = 0.01
FAULTS = ("no data sum", "half the rows")
# the runs: (arch, layers, ssm_impl)
FSDP_RUN = (CS.FSDP_LM_ARCH, CS.FSDP_LM_LAYERS, None)
NORM_RUN = ("zamba2-1.2b", CS.FAMILY_TRAIN_ARCHS["zamba2-1.2b"][1],
            CS.FAMILY_TRAIN_ARCHS["zamba2-1.2b"][0])
# group -> (mesh, [(run, mode, lr, fault)]): one spawn each
CONTROLS = {
    "faults": (CS.FSDP_MESH, [(FSDP_RUN, "fsdp", CS.FSDP_LM_LR, f)
                              for f in FAULTS]),
    "splits": (CS.FSDP_MESH, [(FSDP_RUN, "zero3", LAUNCHER_LR, None),
                              (FSDP_RUN, "fsdp", LAUNCHER_LR, None)]),
    "model split": ((1, 2), [(FSDP_RUN, "tp", LAUNCHER_LR, None)]),
    "families": (CS.FAMILY_TRAIN_MESH, [(NORM_RUN, "tp", CS.FAMILY_TRAIN_LR,
                                         "raw norm sum")]),
}


def raw_norm_sum(x, gamma, mp, width: int, eps: float = 1e-6):
    """`layers.rms_norm_cut` through the raw all-reduce (no autograd form:
    the backward takes this rank's part of the sum's gradient alone)."""
    x32 = x.float()
    var = mp.all_reduce_sum((x32 * x32).sum(-1, keepdim=True)) / width
    return (x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


@contextlib.contextmanager
def planted(fault: str | None):
    """`zoo` and `layers` with `fault` planted while inside (module
    docstring)."""
    saved = Z.reduce_replicated_grads, Z.sum_over, Lyr.rms_norm_cut
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
    try:
        yield
    finally:
        Z.reduce_replicated_grads, Z.sum_over, Lyr.rms_norm_cut = saved


def control_rank(mp, runs: list) -> list[dict]:
    """One rank: `train_lm_rank` of each (run, mode, lr, fault) of `runs`,
    the fault planted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for (arch, layers, impl), mode, lr, fault in runs:
        CS.free_cuda()
        with planted(fault):
            out.append(TLT.train_lm_rank(
                mp, arch, layers, mode, CS.LM_TRAIN_STEPS, CS.LM_TRAIN_BATCH,
                CS.LM_TRAIN_SEQ, 0, False, lr, impl))
    return out


def unsharded(run, lr: float) -> list[float]:
    """The launcher's unsharded steps (`launch.train.lm_train_steps`) of
    the run's config at lr."""
    arch, layers, impl = run
    with contextlib.redirect_stdout(io.StringIO()):
        losses = TLT.lm_train_steps(
            TLT.lm_config(arch, False, layers, impl), CS.LM_TRAIN_STEPS,
            CS.LM_TRAIN_BATCH, CS.LM_TRAIN_SEQ, 0, lr, "cuda")
    CS.free_cuda()
    return losses


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
                print(f"[controls] {run[0]} ({run[1]} layers), unsharded, lr "
                      f"{lr}: losses {want[run, lr]}")
    summary = {"card": card, "runs": []}
    for group in groups:
        shape, runs = CONTROLS[group]
        ranks = spawn_ranks(shape[0] * shape[1], control_rank, (runs,),
                            device="cuda", timeout_s=1200,
                            mesh=train_mesh(*shape))
        for i, (run, mode, lr, fault) in enumerate(runs):
            cfg = TLT.lm_config(run[0], False, run[1], run[2])
            got = [rank[i] for rank in ranks]
            rel = [max(abs(a - c) / abs(c) for a in step) for step, c in
                   zip(zip(*(r["losses"] for r in got)), want[run, lr])]
            shared, differ = CS.shared_bits(cfg, train_mesh(*shape), mode,
                                            got)
            row = dict(arch=cfg.name, layers=cfg.n_layers,
                       ssm_impl=cfg.ssm_impl, mode=mode, mesh=list(shape),
                       lr=lr, fault=fault, unsharded=want[run, lr],
                       losses=[r["losses"] for r in got], rel=rel,
                       loss_bar_met=max(rel) <= CS.LM_TRAIN_RTOL,
                       shared_leaves=shared, shared_bits_equal=not differ)
            print(f"[controls] {cfg.name} ({cfg.n_layers} layers) {mode} over"
                  f" {shape[0]} x {shape[1]}, lr {lr},"
                  f" fault {fault}: losses {got[0]['losses']}, relative "
                  f"difference a step {[float(f'{r:.3g}') for r in rel]} "
                  f"(bar {CS.LM_TRAIN_RTOL}: "
                  f"{'met' if row['loss_bar_met'] else 'missed'}); ranks "
                  f"sharing a piece of {shared} leaves hold "
                  f"{'equal' if not differ else 'different'} bits"
                  + (f" ({len(differ)} mismatches)" if differ else ""))
            summary["runs"].append(row)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
