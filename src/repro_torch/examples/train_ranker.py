"""Train a neural ranker (one of the assigned architectures, smoke-sized)
on the cascade's survivor-scoring task: a pairwise loss on (clicked,
unclicked) items, by autograd and Adam.

    PYTHONPATH=src python -m repro_torch.examples.train_ranker \
        [--arch qwen3-8b] [--steps 200] [--device cpu]

The port's counterpart of `examples/train_ranker.py`.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import configs as CFG
from repro_torch.data import LogConfig, generate_log
from repro_torch.optim import adam
from repro_torch.optim.sgd import apply_updates
from repro_torch.launch.mesh import device_of
from repro_torch.serving.cascade_server import NeuralScorer


def main(argv: list[str] | None = None) -> dict:
    """Prints the loss every tenth of the run and the held-out pairwise
    accuracy; returns {"losses": [...], "accuracy": float}."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "train_ranker")
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--queries", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    cfg = dataclasses.replace(CFG.get_smoke(args.arch), dtype=torch.float32)
    scorer = NeuralScorer.create(cfg, 0, device=device)
    log = generate_log(LogConfig(n_queries=args.queries, seed=2))

    params = {"body": scorer.params, "head": scorer.head}
    opt = adam(args.lr)
    opt_state = opt.init(params)

    def loss_fn(p, pos, neg):
        sc = dataclasses.replace(scorer, params=p["body"], head=p["head"])
        return F.softplus(-(sc.score(pos) - sc.score(neg))).mean()

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree]

    def rebuild(tree, it):
        if isinstance(tree, dict):
            return {k: rebuild(v, it) for k, v in tree.items()}
        return next(it)

    rng = np.random.default_rng(0)
    mask = log.mask.astype(bool)
    pos_pool = log.x[(log.y > 0) & mask]
    neg_pool = log.x[(log.y == 0) & mask]

    def draw(pool):
        return torch.as_tensor(pool[rng.integers(0, len(pool), args.batch)],
                               dtype=torch.float32, device=device)

    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        pos, neg = draw(pos_pool), draw(neg_pool)
        live = [x.detach().requires_grad_(True) for x in leaves(params)]
        loss = loss_fn(rebuild(params, iter(live)), pos, neg)
        # leaves the score never reads (the LM head) get zeros, as under
        # jax.grad
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = rebuild(params, iter(
            torch.zeros_like(x) if g is None else g
            for x, g in zip(live, grads)))
        upd, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, upd)
        losses.append(float(loss.detach()))
        if i % max(1, args.steps // 10) == 0:
            print(f"step {i:4d} pairwise loss {losses[-1]:.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.3f}s/step)")
    sc = dataclasses.replace(scorer, params=params["body"],
                             head=params["head"])
    pos = torch.as_tensor(pos_pool[-256:], dtype=torch.float32, device=device)
    neg = torch.as_tensor(neg_pool[-256:], dtype=torch.float32, device=device)
    with torch.no_grad():
        acc = float((sc.score(pos) > sc.score(neg)).float().mean())
    print(f"held-out pairwise accuracy: {acc:.3f} (random = 0.5)")
    return {"losses": losses, "accuracy": acc}


if __name__ == "__main__":
    main()
