#!/usr/bin/env python3
"""Run chip_smoke.py's [moe lm] phase of two checkouts on one CUDA card,
in turns.

    python3 moe_lm_ab.py OLD_ROOT NEW_ROOT

Each ROOT is the root of a checkout (for example a parent commit unpacked
with `git archive` into a gitignored directory). The trees run in the
order OLD, NEW, NEW, OLD, each turn in a process of its own that imports
that tree's chip_smoke.py (and so its own `src`), builds its kernels and
runs its `phase_moe_lm`: dbrx-132b at 2 layers and arctic-480b at 1 in
bfloat16, a prefill of 4 x 512 tokens and 32 greedy decode steps. A drift
of the card's clocks shows as a difference between a tree's two turns.
Prints the card's name and power limit, each turn's lines, and a JSON
summary as its last line: per turn and config the median ms a decode step,
the CUDA kernel launches a step, the device's idle share and the peak
memory. Exits nonzero if a turn fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

KEYS = ("step_ms_median", "launches_per_step", "device_idle_share",
        "peak_bytes", "k8_launches")
TURN = f"""
import json, sys
import chip_smoke as cs
card = cs.phase_device()
cs.phase_build()
out = cs.phase_moe_lm(card)
print(json.dumps({{a: {{k: r[k] for k in {KEYS!r}}} for a, r in out.items()}}))
"""


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
        run = subprocess.run([sys.executable, "-c", TURN], cwd=trees[name],
                             capture_output=True, text=True, timeout=900)
        lines = run.stdout.strip().splitlines()
        for line in lines[:-1]:
            if not line.startswith("[build]   "):
                print(f"[ab {name}] {line}", flush=True)
        if run.returncode:
            raise SystemExit(f"{name} tree's turn failed:\n{run.stderr}")
        res = json.loads(lines[-1])
        for arch, r in res.items():
            print(f"[ab] {name} {arch}: median {r['step_ms_median']:.3f} ms "
                  f"a decode step, {r['launches_per_step']:.0f} CUDA kernel "
                  f"launches a step, device idle "
                  f"{r['device_idle_share']:.3f}", flush=True)
        turns.append(dict(tree=name, **res))
    print(json.dumps({"turns": turns}))


if __name__ == "__main__":
    main()
