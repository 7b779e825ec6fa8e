"""Training launcher of the port.

Two paths:
  * `--target cloes` — train the paper's cascade (L3) on the synthetic log,
    print the params' digest and the offline metrics of the train and test
    splits. Crash-safe with `--checkpoint-dir` (a checkpoint every
    `--checkpoint-every` epochs and at the last), `--resume` continues
    from the latest good one bit-identically, and `--crash-after-epoch N`
    hard-exits with code 9 after N epochs (the restart smoke's seam).
    `--save PATH` writes the trained params and loss config with
    `checkpoint.save_pytree`. Data parallel under torchrun: each rank
    trains on `cuda:{LOCAL_RANK}` over a 1-D ("data",) mesh of the ranks
    (`launch.mesh.data_parallel_mesh`), rank 0 prints and writes the
    checkpoints; one process takes the plain path.
  * `--target lm --arch <id>` — train any architecture of the model zoo
    (`--smoke`: its reduced variant, in float32) with Adam on random
    tokens: the neural final-stage ranker's substrate; a moe model's loss
    adds its weighted aux loss, an encdec model's batch adds 16 frontend
    frames. `--layers N` keeps the first N layers at the published widths
    (a hybrid keeps N // attn_every applications of its shared block, none
    for N below attn_every, and the header says how many; an encdec model
    keeps the first N layers of its encoder and of its decoder). The
    weights are drawn in float32 whatever the config's dtype, as the
    reference's launcher draws them.
  * `train_lm_rank` — the same LM training over a ("data", "model") mesh
    of ranks under the reference's "tp" layout (every family) or its
    "fsdp" or "zero3" layout (the dense and moe families, "tp" and
    "fsdp" also with the "shmap" attention; `parallel.check_train`)
    (`launch.mesh.spawn_ranks(world,
    train_lm_rank, args, mesh=train_mesh(data, model))`; no CLI flag,
    as the reference's launcher has none): each rank holds its shard of
    the weights and of Adam's moments and trains on its rows of each
    batch; the losses are the unsharded run's (`lm_train_steps`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --target cloes \
      [--queries 1200] [--epochs 6] [--batch-groups 64] [--beta 5] \
      [--lr 0.01] [--seed 0] [--device cuda] [--save cascade] \
      [--checkpoint-dir CKPT [--checkpoint-every 1] [--resume] \
       [--crash-after-epoch 2]]
  torchrun --nproc-per-node N -m repro_torch.launch.train --target cloes ...
  PYTHONPATH=src python -m repro_torch.launch.train --target lm \
      --arch starcoder2-3b|dbrx-132b|rwkv6-1.6b|seamless-m4t-large-v2|... \
      [--smoke | --layers 2] \
      [--steps 30] [--batch 4] [--seq 64]

`--device cpu` runs the kernels' plain versions (and gloo under torchrun).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs as CFG
from repro_torch.checkpoint import save_pytree
from repro_torch.core import baselines as B
from repro_torch.core import losses as L
from repro_torch.core import trainer as T
from repro_torch.data import LogConfig, generate_log
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import data_parallel_mesh, transport
from repro_torch.models import base as MB
from repro_torch.models import zoo as Z
from repro_torch.models.parallel import (TrainLayout, check_train,
                                         local_slices, rank_pieces,
                                         take_pieces)
from repro_torch.optim import adam

# frontend frames of an encdec model's LM batch (the reference's train_lm)
ENC_FRAMES = 16


def params_digest(params) -> str:
    """sha256 over the params' (key, shape, bytes) in key order: a stable
    identity for trajectory-parity checks — the restart smoke compares
    this line between the resumed and the uninterrupted runs."""
    h = hashlib.sha256()
    for k in sorted(params):
        a = np.ascontiguousarray(params[k].detach().cpu().numpy())
        h.update(k.encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def train_cloes(args) -> dict:
    """Under torchrun (WORLD_SIZE > 1) join the process group from its
    environment — NCCL on cuda:{LOCAL_RANK}, gloo on the CPU — and train
    over the data mesh, leaving the group when done; else the plain
    path. Where no world of 2 or more ranks divides --batch-groups, rank 0
    alone takes the plain path (the checkpoint store has one writer) and
    the other ranks return {}, as ranks past the mesh do."""
    device = torch.device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return _train_cloes(args, device, None, 0)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        mesh = data_parallel_mesh(args.batch_groups, device.type)
        rank = dist.get_rank()
        if (rank if mesh is None else mesh.get_coordinate() is None):
            return {}   # a rank past the largest world that divides
        return _train_cloes(args, device, mesh, rank)
    finally:
        dist.destroy_process_group()


def _train_cloes(args, device, mesh, rank) -> dict:
    say = print if rank == 0 else (lambda *a, **k: None)
    log = generate_log(LogConfig(n_queries=args.queries, seed=args.seed))
    tr, te = log.split(0.8)
    lcfg = L.LossConfig(beta=args.beta)
    shards = 1 if mesh is None else mesh.size()
    say(f"[train] CLOES on {device} "
        f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}), "
        f"{shards}-way data parallel, {tr.n_instances} instances")
    t0 = time.perf_counter()
    info: dict = {}
    params, cfg = B.fit_cloes(
        tr, lcfg=lcfg,
        tcfg=T.TrainConfig(loss="l3", epochs=args.epochs, lr=args.lr,
                           batch_groups=args.batch_groups,
                           checkpoint_every=args.checkpoint_every),
        mesh=mesh, checkpoint_dir=args.checkpoint_dir or None,
        resume=args.resume, crash_after_epoch=args.crash_after_epoch,
        train_info=info, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    say(f"[train] done in {time.perf_counter() - t0:.1f}s "
        f"(restored_epoch={info.get('restored_epoch', 0)} "
        f"epochs_run={info.get('epochs_run', args.epochs)})")
    say(f"[train] params sha256={params_digest(params)}")
    out = {}
    for split, data in [("train", tr), ("test", te)]:
        m = T.evaluate(params, cfg, data, lcfg)
        out[split] = m
        say(f"[eval:{split}] " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
    if args.save and rank == 0:
        save_pytree(args.save, {"params": params,
                                "lcfg": dataclasses.asdict(lcfg)})
        say(f"[ckpt] saved to {args.save}")
    return out


def lm_batch(cfg, rng: np.random.Generator, bsz: int, s: int,
             device) -> dict[str, torch.Tensor]:
    """One batch of random tokens (the reference's `train_lm` draw): s + 1
    tokens per row, shifted into inputs and targets; then, from the same
    stream, an encdec config's ENC_FRAMES frontend frames (its tokens
    uncut), or a vlm config's P frontend positions with its text cut to
    s - P; frames are 0.1 N(0, 1) in float32."""
    tok = rng.integers(0, cfg.vocab, (bsz, s + 1))
    batch = {"tokens": torch.as_tensor(tok[:, :-1], device=device),
             "targets": torch.as_tensor(tok[:, 1:], device=device)}
    if cfg.frontend_positions:
        p_ = (ENC_FRAMES if cfg.arch_type == "encdec"
              else cfg.frontend_positions)
        fe = 0.1 * rng.normal(size=(bsz, p_, cfg.d_model))
        batch["frontend"] = torch.as_tensor(fe, dtype=torch.float32,
                                            device=device)
        if cfg.arch_type != "encdec":
            batch["tokens"] = batch["tokens"][:, :s - p_]
            batch["targets"] = batch["targets"][:, :s - p_]
    return batch


def batch_rows(batch: dict, mesh, rank: int) -> dict:
    """Rank `rank`'s part of an LM batch on `mesh` (`sharding
    .batch_layouts`): its block of the rows, every row where the mesh has
    one data rank. A batch the data ranks do not divide raises: each rank
    would hold every row, and the rows would count once a rank."""
    n_data = mesh.shape["data"]
    specs = SH.batch_layouts({k: tuple(v.shape) for k, v in batch.items()},
                             mesh)
    out = {}
    for k, v in batch.items():
        if n_data > 1 and specs[k][0] is None:
            raise ValueError(f"a batch of {v.shape[0]} rows cannot be cut "
                             f"over {n_data} data ranks")
        out[k] = take_pieces(v, [[blk] for blk in local_slices(
            tuple(v.shape), specs[k], mesh, rank)])
    return out


def lm_config(arch: str, smoke: bool, layers: int,
              ssm_impl: str | None = None, attn_shard: str | None = None):
    """The launcher's LM config: the arch's (its smoke variant in
    float32), cut to its first `layers` layers (0: all), its recurrent
    layers in the form `ssm_impl` where given ("scan" or "chunked", the
    reference's dry run's choice for training), its attention variant
    `attn_shard` where given ("shmap": the reference's shard_map attention
    and MoE, its dry run's choice where the heads or kv heads do not
    divide the model axis)."""
    cfg = CFG.get_smoke(arch) if smoke else CFG.get(arch)
    return dataclasses.replace(
        cfg, dtype=torch.float32 if smoke else cfg.dtype,
        n_layers=layers or cfg.n_layers,
        n_enc_layers=(layers or cfg.n_enc_layers) if cfg.n_enc_layers
        else 0, ssm_impl=ssm_impl or cfg.ssm_impl,
        attn_shard=attn_shard or cfg.attn_shard)


def shared_leaves(templates, specs, mesh, rank: int) -> list[int]:
    """The leaves (tree order) of which another rank of `mesh` holds the
    same pieces as `rank` under the layout `specs` (the norms everywhere,
    a leaf along the axes its layout leaves out): two such ranks hold the
    same bits of it after every step."""
    held = [list(MB.tree_leaves(rank_pieces(templates, specs, mesh, r)))
            for r in range(mesh.size)]
    return [i for i, mine in enumerate(held[rank])
            if any(other[i] == mine for r, other in enumerate(held)
                   if r != rank)]


def _digest(a: torch.Tensor) -> str:
    return hashlib.sha256(a.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def train_lm_rank(mp, arch: str, layers: int, mode: str, steps: int,
                  batch: int, seq: int, seed: int, smoke: bool = False,
                  lr: float = 0.01, ssm_impl: str | None = None,
                  attn_shard: str | None = None) -> dict:
    """One rank of `train_lm` (`lm_config(arch, smoke, layers, ssm_impl,
    attn_shard)`)
    over mp's ("data", "model") mesh under the layout `mode` ("tp",
    "fsdp", "zero3"; `parallel.check_train`): it
    draws the weights on the CPU from the seed as `train_lm` does and keeps
    its shard (`materialize_shard`, float32), draws each of the launcher's
    batches and keeps its rows (`batch_rows`), and takes `steps` Adam steps
    (`zoo.train_step` with the layout). Returns the losses (the unsharded
    run's), each step's collectives by kind (calls and bytes) and seconds,
    the bytes of its params + Adam's m and v, its peak device memory (None
    on the CPU), its transport and the number of cards of the run, and
    after the last step a sha256 of each leaf of params, m and v that
    another rank holds too (`shared_leaves`; leaf index -> digest)."""
    cfg = lm_config(arch, smoke, layers, ssm_impl, attn_shard)
    check_train(cfg, mp.mesh, mode)
    dev = mp.device
    tmpl = Z.templates(cfg)
    layout = TrainLayout(mode, SH.param_layouts(tmpl, mp.mesh, mode))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = MB.tree_map(lambda a: a.to(dev), MB.materialize_shard(
        tmpl, torch.Generator().manual_seed(seed), torch.float32,
        layout.specs, mp))
    opt = adam(lr)
    opt_state = opt.init(params)
    state_bytes = sum(a.numel() * a.element_size() for tree in (
        params, opt_state["m"], opt_state["v"]) for a in MB.tree_leaves(tree))
    rng = np.random.default_rng(seed)
    losses, calls, nbytes, seconds = [], [], [], []
    for _ in range(steps):
        rows = batch_rows(lm_batch(cfg, rng, batch, seq, "cpu"), mp.mesh,
                          mp.global_rank)
        rows = {k: v.to(dev) for k, v in rows.items()}
        mp.reset_counts()
        t0 = time.perf_counter()
        params, opt_state, loss = Z.train_step(params, opt_state, rows, cfg,
                                               opt.update, mp, layout)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
        calls.append(dict(mp.calls))
        nbytes.append(dict(mp.bytes))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    cards = (len({str(d) for d in transport(mp.mesh.size, dev)[1]})
             if dev.type == "cuda" else 0)
    shared = shared_leaves(tmpl, layout.specs, mp.mesh, mp.global_rank)
    digests = {kind: {i: _digest(a) for i, a in enumerate(MB.tree_leaves(
        tree)) if i in shared} for kind, tree in (
            ("params", params), ("m", opt_state["m"]), ("v", opt_state["v"]))}
    return dict(losses=losses, calls=calls, bytes=nbytes, seconds=seconds,
                state_bytes=state_bytes, digests=digests,
                peak_bytes=peak, backend=mp.backend, cards=cards)


def lm_train_steps(cfg, steps: int, batch: int, seq: int, seed: int,
                   lr: float, device) -> list[float]:
    """`steps` Adam steps of cfg on random tokens from the seed's numpy
    stream; the weights are `materialize`d on the CPU from the seed and
    moved to `device`, so every device (and every rank's shard,
    `train_lm_rank`) trains the same model. Returns every step's loss."""
    device = torch.device(device)
    params = MB.tree_map(
        lambda p: p.to(device),
        MB.materialize(Z.templates(cfg), torch.Generator().manual_seed(seed)))
    n_params = sum(p.numel() for p in MB.tree_leaves(params))
    shared = (f", {Z.shared_applications(cfg)} shared-block applications"
              if cfg.arch_type == "hybrid" else
              f" + {cfg.n_enc_layers} encoder layers"
              if cfg.arch_type == "encdec" else "")
    print(f"[train] {cfg.name}: {cfg.n_layers} layers{shared}, "
          f"{n_params / 1e6:.1f}M params, {steps} steps on {device}")
    opt = adam(lr)
    opt_state = opt.init(params)
    rng = np.random.default_rng(seed)
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        params, opt_state, loss = Z.train_step(
            params, opt_state, lm_batch(cfg, rng, batch, seq, device), cfg,
            opt.update)
        losses.append(float(loss))
        if step % max(1, steps // 10) == 0:
            print(f"  step {step:4d} loss {losses[-1]:.4f} "
                  f"({(time.perf_counter() - t0) / (step + 1):.2f}s/step)")
    print(f"[train] final loss {losses[-1]:.4f}")
    return losses


def train_lm(args) -> list[float]:
    """`lm_train_steps` of the launcher's LM config on `--device`."""
    return lm_train_steps(lm_config(args.arch, args.smoke, args.layers),
                          args.steps, args.batch, args.seq, args.seed,
                          args.lr, args.device)


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", choices=["cloes", "lm"], default="cloes")
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="lm target: keep the first N layers (0: all; an "
                         "encdec model keeps N of its encoder and N of its "
                         "decoder)")
    ap.add_argument("--queries", type=int, default=1200)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch-groups", type=int, default=64)
    ap.add_argument("--beta", type=float, default=5.0)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--save", default="")
    ap.add_argument("--checkpoint-dir", default="",
                    help="crash-safe per-epoch checkpoints (cloes target)")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="epochs between checkpoints (with --checkpoint-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest good checkpoint")
    ap.add_argument("--crash-after-epoch", type=int, default=None,
                    help="test seam: hard-exit (code 9) after N epochs")
    args = ap.parse_args(argv)
    if args.target == "cloes":
        return train_cloes(args)
    return train_lm(args)


if __name__ == "__main__":
    main()
