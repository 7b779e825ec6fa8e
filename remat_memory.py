#!/usr/bin/env python3
"""Where a gradient pass's peak device memory goes, with remat and without
(the test seam `zoo._REMAT`), against the cost report's trace of the same
pass on `meta` tensors: starcoder2-3b at its published widths, 2 layers,
bfloat16, one sequence of 4,096 tokens (chip_smoke.py's `[remat lm]`
comparison), on one CUDA card.

    PYTHONPATH=src python3 remat_memory.py

Prints, for each mode, the card's peak above the weights and batch
(`torch.cuda.max_memory_allocated`) over `zoo.lm_loss` and its
`autograd.grad`, the trace's peak temporaries for the same pass
(`launch.dryrun`'s `StepCounter`), and for the rematted pass the largest
blocks live at the card's peak, from a CUDA memory snapshot of the pass
(`torch.cuda.memory._record_memory_history`), each with the port's
frames that allocated it (none: the autograd engine's backward).
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs as CFG  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.models import base as MB  # noqa: E402
from repro_torch.models import zoo as Z  # noqa: E402

ARCH, LAYERS, BATCH, SEQ = "starcoder2-3b", 2, 1, 4096


def card_pass(cfg, snapshot: bool) -> tuple[int, list]:
    """The card's peak above the weights and batch over one gradient pass,
    and with `snapshot` the largest blocks live at it (size, frames)."""
    params = MB.materialize(Z.templates(cfg),
                            torch.Generator(device="cuda").manual_seed(0),
                            dtype=cfg.dtype)
    leaves = MB.tree_map(lambda p: p.requires_grad_(True), params)
    batch = TLT.lm_batch(cfg, np.random.default_rng(0), BATCH, SEQ, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    if snapshot:
        torch.cuda.memory._record_memory_history(max_entries=200_000)
    loss = Z.lm_loss(leaves, cfg, batch)
    grads = torch.autograd.grad(loss, list(MB.tree_leaves(leaves)))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    blocks = []
    if snapshot:
        events = torch.cuda.memory._snapshot()["device_traces"][0]
        torch.cuda.memory._record_memory_history(enabled=None)
        live, cur, best, at_best = {}, 0, 0, {}
        for ev in events:
            if ev["action"] == "alloc":
                live[ev["addr"]] = ev
                cur += ev["size"]
                if cur > best:
                    best, at_best = cur, dict(live)
            elif ev["action"] == "free_completed" and ev["addr"] in live:
                cur -= live.pop(ev["addr"])["size"]
        for ev in sorted(at_best.values(), key=lambda e: -e["size"])[:8]:
            frames = [f"{f['filename'].rsplit('/', 1)[-1]}:{f['line']} "
                      f"{f['name']}" for f in ev.get("frames", ())
                      if "repro_torch" in f["filename"]][:3]
            blocks.append((ev["size"], frames))
    del grads, loss, leaves, params, batch
    torch.cuda.empty_cache()
    return peak, blocks


def meta_pass(cfg) -> int:
    """The trace's peak temporaries of the same pass."""
    args = D.step_inputs(cfg, "train", batch=BATCH, seq_len=SEQ)
    leaves = MB.tree_map(lambda p: p.requires_grad_(True), args["params"])

    def run():
        loss = Z.lm_loss(leaves, cfg, args["batch"])
        return torch.autograd.grad(loss, list(MB.tree_leaves(leaves)))

    return D._trace(run, D._tensors(args))["memory"]["temp_size_in_bytes"]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("remat_memory.py measures a CUDA card; none here")
    cfg = dataclasses.replace(CFG.get(ARCH), n_layers=LAYERS)
    print(f"card: {torch.cuda.get_device_name(0)}; {cfg.name}, {LAYERS} "
          f"layers, {cfg.dtype}, {BATCH} x {SEQ} tokens", flush=True)
    for remat in (True, False):
        Z._REMAT = remat
        try:
            peak, blocks = card_pass(cfg, snapshot=remat)
            trace = meta_pass(cfg)
        finally:
            Z._REMAT = True
        print(f"[remat memory] {'remat' if remat else 'no remat'}: the "
              f"card's peak {peak} bytes above the weights and batch, the "
              f"trace's {trace} ({peak - trace:+d})", flush=True)
        for size, frames in blocks:
            print(f"[remat memory]   live at the peak: {size} bytes "
                  f"{frames or '(the autograd engine)'}", flush=True)


if __name__ == "__main__":
    main()
