#!/usr/bin/env python3
"""Run chip_smoke.py's training phases over ranks of two checkouts on one
CUDA card, in turns: what a change to the train step costs them.

    python3 train_ab.py OLD_ROOT NEW_ROOT

Each ROOT is the root of a checkout (for example a parent commit unpacked
with `git archive` into a gitignored directory). The trees run in the
order OLD, NEW, NEW, OLD, each turn in a process of its own that imports
that tree's chip_smoke.py (and so its own `src`), builds its kernels and
runs its `phase_fsdp` ([fsdp parity], [shmap train parity], [fsdp lm],
[zero3 families parity], [zero3 serve parity], [zero3 lm]),
`phase_tp_qsplit_lm` ([tp qsplit lm] and [shmap train lm]) and
`phase_tp_families_train`. Prints the card's name and power limit, each
phase's seconds and rank 0's seconds a step of each training run, and a
JSON summary of them as its last line. Exits nonzero if a turn fails.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

PHASES = ("phase_fsdp", "phase_tp_qsplit_lm", "phase_tp_families_train")
TURN = f"""
import time
import chip_smoke as cs
card = cs.phase_device()
cs.phase_build()
for name in {PHASES!r}:
    t0 = time.perf_counter()
    getattr(cs, name)(card)
    cs.free_cuda()
    print(f"[phase] {{name}} {{time.perf_counter() - t0:.1f}}", flush=True)
"""
# rank 0's line of a training run: "[tag]   ... rank 0: ... seconds a step
# [a, b, c]; ..."
STEPS = re.compile(r"^(\[[^\]]+\])\s+(.*?)rank 0:.*?seconds a step "
                   r"\[([^\]]*)\]")


def main() -> None:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    trees = {"old": os.path.abspath(sys.argv[1]),
             "new": os.path.abspath(sys.argv[2])}
    turns = []
    for name in ("old", "new", "new", "old"):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", TURN], cwd=trees[name],
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            raise SystemExit(f"{name} tree's turn failed:\n"
                             f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
        turn = dict(tree=name, seconds=round(time.perf_counter() - t0, 1),
                    phases={}, steps={})
        for line in run.stdout.splitlines():
            if line.startswith("[phase] "):
                _, phase, s = line.split()
                turn["phases"][phase] = float(s)
            m = STEPS.match(line)
            if m:
                tag = f"{m.group(1)} {m.group(2).strip()}".strip()
                turn["steps"][tag] = [float(v) for v in
                                      m.group(3).split(",")]
        for phase, s in turn["phases"].items():
            print(f"[ab] {name} {phase}: {s:.1f} s", flush=True)
        for tag, steps in turn["steps"].items():
            print(f"[ab] {name} {tag}: rank 0's seconds a step {steps}",
                  flush=True)
        turns.append(turn)
    print(json.dumps({"turns": turns}))


if __name__ == "__main__":
    main()
