#!/usr/bin/env python3
"""Check and time the port's kernels of two source trees on one CUDA card,
in turns.

    python3 kernel_ab.py OLD_SRC NEW_SRC

Each SRC is the `src` directory of a checkout (for example a parent commit
unpacked with `git archive` into a gitignored directory). The trees run in
the order OLD, NEW, NEW, OLD, each in its own process (both packages are
named `repro_torch`), so a drift of the card's clocks shows as a difference
between a tree's two turns. A turn runs chip_smoke.py's own code on its
tree (through CHIP_SMOKE_SRC): each kernel of AB_SHAPES against its plain
version at chip_smoke's bars (`check_alone`), then timed as chip_smoke
times it (`time_shape`), and in each tree's first turn the two-stream K8
check (`phase_k8_streams`) and the widest d each wrapper of
chip_smoke's PREV_WIDEST_D takes (`widest_d`: on the parent, the previous
designs' limits that chip_smoke holds the new ones to). A failed check is
recorded rather than raised,
so an old tree's failures print beside the new tree's passes; the script
exits nonzero if the NEW tree fails any. Prints the card's name and power
limit, chip_smoke's lines of every turn, and a JSON summary as its last
line.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# (chip_smoke's shape constant, its seed there, the kernels compared at it)
REDESIGNED = ("cascade_score_batched", "cascade_score_batched_bwd",
              "cascade_loss", "cascade_loss_bwd")
AB_SHAPES = (("TIMING_SHAPE", 7, REDESIGNED),
             ("SERVE_SHAPE", 9, ("cascade_score_batched",)),
             ("TRAIN_SHAPE", 8, REDESIGNED))


def turn(src: str, streams: bool) -> dict:
    os.environ["CHIP_SMOKE_SRC"] = os.path.abspath(src)
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    cs.phase_build()                   # prints the build and ptxas lines
    rows, failed = [], []
    for const, seed, names in AB_SHAPES:
        shape = getattr(cs, const)
        errs = collections.defaultdict(float)
        for name in names:
            try:
                cs.check_alone(name, shape, seed, errs)
            except AssertionError as e:
                failed.append(f"{name} at {shape}: {e}")
        for name, r in cs.time_shape(shape, seed, names).items():
            rows.append(dict(kernel=name, shape=shape, ms=r["ms"],
                             bound_ms=r["bound_ms"],
                             max_abs_err=errs[name]))
    if streams:
        try:
            cs.phase_k8_streams()
        except AssertionError as e:
            failed.append(f"k8 streams: {e}")
        widest = [dict(kernel=name, t=t, d=cs.widest_d(name, t))
                  for name, t in cs.PREV_WIDEST_D]
    else:
        widest = []
    return dict(rows=rows, failed=failed, widest=widest)


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--turn":
        print(json.dumps(turn(sys.argv[2], sys.argv[3] == "1")))
        return
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    trees = {"old": sys.argv[1], "new": sys.argv[2]}
    turns, seen = [], set()
    for name in ("old", "new", "new", "old"):
        streams = name not in seen
        seen.add(name)
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", trees[name],
             str(int(streams))], capture_output=True, text=True, timeout=900)
        lines = run.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(f"[ab {name}] {line}")
        if run.returncode:
            raise SystemExit(f"{name} tree's turn failed:\n{run.stderr}")
        res = json.loads(lines[-1])
        for r in res["rows"]:
            print(f"[ab] {name} {r['kernel']} at {tuple(r['shape'])}: "
                  f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_ms'] / r['ms']:.1%}), max |err| against the "
                  f"plain version {r['max_abs_err']:.3g}")
        for r in res["widest"]:
            print(f"[ab] {name} {r['kernel']} takes d <= {r['d']} at "
                  f"T={r['t']}")
        for f in res["failed"]:
            print(f"[ab] {name} FAILED {f}")
        turns.append(dict(tree=name, **res))
    print(json.dumps({"turns": turns}))
    if any(t["failed"] for t in turns if t["tree"] == "new"):
        raise SystemExit("kernel_ab: the new tree failed a check")


if __name__ == "__main__":
    main()
