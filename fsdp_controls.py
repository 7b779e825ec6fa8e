#!/usr/bin/env python3
"""Controls of chip_smoke.py's [fsdp lm] checks on one CUDA card: what a
planted fault does to what they read, and how far each split of the step
alone moves the losses.

    python3 fsdp_controls.py

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

# two ranks of the unsharded step's half each fill most of the card;
# segments that grow keep the allocator's free blocks from splitting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import chip_smoke as CS  # noqa: E402
import torch  # noqa: E402

from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks, train_mesh  # noqa: E402
from repro_torch.models import zoo as Z  # noqa: E402

LAUNCHER_LR = 0.01
FAULTS = ("no data sum", "half the rows")
# (mesh, [(mode, lr, fault)]): one spawn each
CONTROLS = [(CS.FSDP_MESH, [("fsdp", CS.FSDP_LM_LR, f) for f in FAULTS]
             + [("zero3", LAUNCHER_LR, None), ("fsdp", LAUNCHER_LR, None)]),
            ((1, 2), [("tp", LAUNCHER_LR, None)])]


@contextlib.contextmanager
def planted(fault: str | None):
    """`zoo` with `fault` planted while inside (module docstring)."""
    saved = Z.reduce_replicated_grads, Z.sum_over
    if fault == "no data sum":
        Z.reduce_replicated_grads = lambda mp, grads, specs: grads
    elif fault == "half the rows":
        def sum_over(mp, x, axes):
            if axes == ("data",) and mp.data_rank == 1:
                x = x.detach() + 0 * x
            return saved[1](mp, x, axes)
        Z.sum_over = sum_over
    try:
        yield
    finally:
        Z.reduce_replicated_grads, Z.sum_over = saved


def control_rank(mp, runs: list) -> list[dict]:
    """One rank: `train_lm_rank` of [fsdp lm]'s run for each (mode, lr,
    fault) of `runs`, the fault planted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for mode, lr, fault in runs:
        CS.free_cuda()
        with planted(fault):
            out.append(TLT.train_lm_rank(
                mp, CS.FSDP_LM_ARCH, CS.FSDP_LM_LAYERS, mode,
                CS.LM_TRAIN_STEPS, CS.LM_TRAIN_BATCH, CS.LM_TRAIN_SEQ, 0,
                False, lr))
    return out


def unsharded(lr: float) -> list[float]:
    """The launcher's --target lm run of [fsdp lm]'s config at lr."""
    with contextlib.redirect_stdout(io.StringIO()):
        losses = TLT.main([
            "--target", "lm", "--arch", CS.FSDP_LM_ARCH, "--layers",
            str(CS.FSDP_LM_LAYERS), "--steps", str(CS.LM_TRAIN_STEPS),
            "--batch", str(CS.LM_TRAIN_BATCH), "--seq",
            str(CS.LM_TRAIN_SEQ), "--lr", str(lr), "--device", "cuda"])
    CS.free_cuda()
    return losses


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fsdp_controls: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    cfg = TLT.lm_config(CS.FSDP_LM_ARCH, False, CS.FSDP_LM_LAYERS)
    want = {lr: unsharded(lr) for lr in (CS.FSDP_LM_LR, LAUNCHER_LR)}
    for lr, losses in want.items():
        print(f"[controls] unsharded, lr {lr}: losses {losses}")
    summary = {"card": card, "arch": cfg.name, "layers": cfg.n_layers,
               "unsharded": {str(lr): v for lr, v in want.items()},
               "runs": []}
    for shape, runs in CONTROLS:
        ranks = spawn_ranks(shape[0] * shape[1], control_rank, (runs,),
                            device="cuda", timeout_s=1200,
                            mesh=train_mesh(*shape))
        for i, (mode, lr, fault) in enumerate(runs):
            got = [rank[i] for rank in ranks]
            rel = [max(abs(a - c) / abs(c) for a in step) for step, c in
                   zip(zip(*(run["losses"] for run in got)), want[lr])]
            shared, differ = CS.shared_bits(cfg, train_mesh(*shape), mode,
                                            got)
            row = dict(mode=mode, mesh=list(shape), lr=lr, fault=fault,
                       losses=[run["losses"] for run in got], rel=rel,
                       loss_bar_met=max(rel) <= CS.LM_TRAIN_RTOL,
                       shared_leaves=shared, shared_bits_equal=not differ)
            print(f"[controls] {mode} over {shape[0]} x {shape[1]}, lr {lr},"
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
