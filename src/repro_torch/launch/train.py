"""Training launcher of the port: train the paper's cascade (L3) on the
synthetic log, print the params' digest and the offline metrics of the
train and test splits.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --target cloes \
      [--queries 1200] [--epochs 6] [--batch-groups 64] [--beta 5] \
      [--lr 0.01] [--seed 0] [--device cuda]

`--device cpu` runs the kernels' plain versions. The reference launcher's
`--target lm` and its checkpoint flags are not ported yet.
"""

from __future__ import annotations

import argparse
import hashlib
import time

import numpy as np
import torch

from repro_torch.core import baselines as B
from repro_torch.core import losses as L
from repro_torch.core import trainer as T
from repro_torch.data import LogConfig, generate_log


def params_digest(params) -> str:
    """sha256 over the params' (key, shape, bytes) in key order: a stable
    identity for trajectory-parity checks."""
    h = hashlib.sha256()
    for k in sorted(params):
        a = np.ascontiguousarray(params[k].detach().cpu().numpy())
        h.update(k.encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def train_cloes(args) -> dict:
    log = generate_log(LogConfig(n_queries=args.queries, seed=args.seed))
    tr, te = log.split(0.8)
    lcfg = L.LossConfig(beta=args.beta)
    device = torch.device(args.device)
    print(f"[train] CLOES on {device} "
          f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}), "
          f"{tr.n_instances} instances")
    t0 = time.perf_counter()
    params, cfg = B.fit_cloes(
        tr, lcfg=lcfg,
        tcfg=T.TrainConfig(loss="l3", epochs=args.epochs, lr=args.lr,
                           batch_groups=args.batch_groups),
        device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[train] done in {time.perf_counter() - t0:.1f}s")
    print(f"[train] params sha256={params_digest(params)}")
    out = {}
    for split, data in [("train", tr), ("test", te)]:
        m = T.evaluate(params, cfg, data, lcfg)
        out[split] = m
        print(f"[eval:{split}] " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", choices=["cloes"], default="cloes")
    ap.add_argument("--queries", type=int, default=1200)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch-groups", type=int, default=64)
    ap.add_argument("--beta", type=float, default=5.0)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the kernels' "
                         "plain versions)")
    return train_cloes(ap.parse_args(argv))


if __name__ == "__main__":
    main()
