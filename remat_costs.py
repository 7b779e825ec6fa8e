#!/usr/bin/env python3
"""The cost report's train steps with and without remat (the port's
activation checkpointing of every block, `zoo._remat`; without it through
the test seam `zoo._REMAT`), traced on `meta` tensors on the host's CPU
(`launch/dryrun.py`; nothing is allocated, but full-width, full-depth
traces take a host of their own: run it on a machine with spare cores,
not beside other work):

  * one card: starcoder2-3b at its published widths, float32 (as the
    launcher draws the weights) and bfloat16 (its published dtype), at
    several depths and batches of train_4k's 4,096-token sequences;
  * a rank of dbrx-132b at 2 layers under "fsdp" on a 2 x 2 mesh,
    float32, 4 x 64 tokens (`launch.train.lm_config`; ROADMAP item 28),
    each class of ranks.

Each line: argument and temp GB (the peak of the storages the step makes)
and their sum, with remat and without. Usage (up to 8 processes):

    PYTHONPATH=src python3 remat_costs.py [--out FILE.json]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import torch  # noqa: E402

from repro_torch import configs as CFG  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.launch.mesh import train_mesh  # noqa: E402
from repro_torch.models import zoo as Z  # noqa: E402

ARCH, SEQ = "starcoder2-3b", 4096
# (dtype, layers, batch, seq)
CARD = [("float32", 1, 1, SEQ), ("float32", 2, 1, SEQ),
        ("float32", 30, 1, SEQ), ("float32", 30, 2, SEQ),
        ("float32", 30, 1, 16),
        ("bfloat16", 1, 2, SEQ), ("bfloat16", 2, 2, SEQ),
        ("bfloat16", 30, 1, SEQ), ("bfloat16", 30, 2, SEQ),
        ("bfloat16", 30, 1, 16)]
ITEM28 = ("dbrx-132b", 2, (2, 2), "fsdp", 4, 64)


def card_row(dtype: str, layers: int, b: int, s: int, remat: bool) -> dict:
    """One card's train step of ARCH (`dryrun.step_record`)."""
    cfg = dataclasses.replace(CFG.get(ARCH), n_layers=layers,
                              dtype=getattr(torch, dtype))
    Z._REMAT = remat
    rec = D.step_record(cfg, "train", batch=b, seq_len=s)
    mem = rec["memory"]
    return dict(what=f"{ARCH} {dtype} {layers} layers {b} x {s}",
                remat=remat, args=mem["argument_size_in_bytes"],
                temp=mem["temp_size_in_bytes"],
                flops=rec["cost"]["flops"], trace_s=rec["trace_s"])


def item28_rows(remat: bool) -> list[dict]:
    """Each class of ranks of ITEM28's step (`dryrun.rank_class_records`)."""
    arch, layers, mesh, mode, b, s = ITEM28
    cfg = TLT.lm_config(arch, False, layers)
    Z._REMAT = remat
    out = []
    for rec in D.rank_class_records(cfg, "train", train_mesh(*mesh),
                                    batch=b, seq_len=s, mode=mode,
                                    param_dtype=torch.float32):
        mem = rec["memory"]
        out.append(dict(
            what=f"{arch} {layers} layers {mode} {mesh[0]} x {mesh[1]} "
                 f"float32 {b} x {s}, ranks {rec['ranks']}",
            remat=remat, args=mem["argument_size_in_bytes"],
            temp=mem["temp_size_in_bytes"], calls=rec["calls"],
            flops=rec["cost"]["flops"], trace_s=rec["trace_s"]))
    return out


def line(r: dict) -> str:
    return (f"{r['what']}, {'remat' if r['remat'] else 'no remat'}: "
            f"arguments {r['args'] / 1e9:.3f} GB + temp "
            f"{r['temp'] / 1e9:.3f} GB = {(r['args'] + r['temp']) / 1e9:.3f}"
            f" GB (flops {r['flops']:.4e}; trace {r['trace_s']} s)")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    pool = concurrent.futures.ProcessPoolExecutor(
        min(8, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"))
    try:
        card = [pool.submit(card_row, *row, remat)
                for row in sorted(CARD, key=lambda r: -r[1] * r[2] * r[3])
                for remat in (True, False)]
        item28 = [pool.submit(item28_rows, remat) for remat in (True, False)]
        rows = [f.result() for f in card] + [r for f in item28
                                             for r in f.result()]
    finally:
        pool.shutdown()
    for r in rows:
        print(line(r), flush=True)
    print(f"[done] {len(rows)} traces in {time.perf_counter() - t0:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=str)


if __name__ == "__main__":
    main()
