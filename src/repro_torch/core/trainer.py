"""SGD trainer for the CLOES cascade (paper §3.2: minibatch SGD, params
initialized near zero), ported from the reference's `core/trainer.py`.
Batches are query groups so the per-query reductions of Eqs 10/16 are
local sums.

Two engines behind the same `fit()` API, visiting the same minibatches in
the same order (host numpy permutations, the reference's RNG stream):

  * ``engine="scan"`` (default) — the log is packed and uploaded to the
    device ONCE, with the param-independent loss terms precomputed
    (`_engine_pack`); each epoch gathers it on the device by the host
    permutation, once, and then runs one eager step per minibatch, with
    the parameters and the momentum each one raveled vector. The packed
    item array is the layout the fused L3 op reads
    (`kernels.ops.cascade_loss_fused`), so the default objective is one
    forward and one backward kernel per step on the card. With
    TrainConfig.precision="bf16" the item array is stored in bfloat16 and
    up-cast once per epoch, after the gather; TrainConfig.loss_scale
    scales the optimized objective.
  * ``engine="loop"`` — one step per minibatch over host batches uploaded
    per step, parameters as a dict: the trajectory-parity oracle.

The reference's scan engine is one `jax.lax.scan` per epoch; the port runs
the same steps eagerly (capturing a step as a CUDA graph is later work).

The scan engine is also the one with durable state and data parallelism:
`fit(checkpoint_dir=...)` commits the reference's state tree to a
`checkpoint.CheckpointStore` (so each package resumes the other's
checkpoints) and `fit(mesh=...)` shards each minibatch over a
`torch.distributed` data mesh (`launch.mesh.data_parallel_mesh`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import cascade as C
from repro_torch.core import losses as L
from repro_torch.core import metrics as M
from repro_torch.data.synthetic import SearchLog
from repro_torch.kernels.cascade_loss.kernel import pack_items
from repro_torch.optim.sgd import apply_updates, momentum_sgd

# Exit code of the deterministic crash seam (fit(crash_after_epoch=k)):
# os._exit at this code models SIGKILL — no finally blocks, no atexit, no
# flush — so the restart smoke exercises exactly what a preemption leaves
# behind. 9 on purpose (the SIGKILL signal number).
CRASH_EXIT_CODE = 9


@dataclasses.dataclass
class TrainConfig:
    loss: str = "l3"           # l1 | l2 | l3
    lr: float = 0.05
    momentum: float = 0.9
    batch_groups: int = 64     # query groups per minibatch
    epochs: int = 10
    seed: int = 0
    log_every: int = 200
    engine: str = "scan"       # scan | loop (see module docstring)
    # Storage precision of the packed item array (scan engine only):
    # "bf16" halves its footprint and the per-epoch gather; every consumer
    # accumulates in f32. The small group array stays f32 (m_q/mn/n_o_eff
    # reach the thousands, where bf16 would shift the penalty targets).
    precision: str = "f32"     # f32 | bf16
    # Static loss scale (scan engine only): the step optimizes
    # loss * loss_scale and unscales the gradient before the update.
    loss_scale: float = 1.0
    # Snapshot (params + momentum + epoch + rng key) to fit()'s
    # checkpoint_dir every this-many epochs (scan engine only; 0 with a
    # checkpoint_dir means every epoch). The final epoch is always
    # snapshotted. An epoch is a pure function of the restored state — the
    # minibatch order is re-derived from seed+epoch — so a resumed run is
    # bit-identical to the uninterrupted one.
    checkpoint_every: int = 0


def epoch_steps(n_groups: int, batch_groups: int) -> tuple[int, int]:
    """(full minibatches per epoch, query groups DROPPED from the tail).
    The tail partial batch is dropped so every step sees the same
    (batch_groups, G) shapes; a fresh permutation each epoch means no
    group is systematically lost."""
    steps = n_groups // batch_groups
    return steps, n_groups - steps * batch_groups


def _epoch_perm(n_groups: int, batch_groups: int, seed: int) -> np.ndarray:
    """Host-side minibatch index plan for one epoch: (steps, batch_groups),
    from the reference's RNG stream, so both engines (and both packages)
    visit identical minibatches."""
    steps, _ = epoch_steps(n_groups, batch_groups)
    perm = np.random.default_rng(seed).permutation(n_groups)
    return perm[:steps * batch_groups].reshape(steps, batch_groups)


def _log_arrays(log: SearchLog, device, idx=None) -> dict[str, torch.Tensor]:
    """The log (or its groups `idx`) as tensors on `device`."""
    def take(a, dtype=torch.float32):
        a = np.asarray(a if idx is None else a[idx])
        return torch.as_tensor(a, dtype=dtype, device=device)
    return {
        "x": take(log.x), "q": take(log.q), "y": take(log.y),
        "mask": take(log.mask),
        "behavior": take(log.behavior, torch.int64),
        "price": take(log.price), "m_q": take(log.m_q),
    }


def batches(log: SearchLog, batch_groups: int, seed: int,
            device="cuda") -> Iterator[dict]:
    """Host-side minibatch iterator (the loop engine's data path): each
    minibatch is uploaded when it is used. The tail partial batch is
    dropped — see `epoch_steps`."""
    for idx in _epoch_perm(log.x.shape[0], batch_groups, seed):
        yield _log_arrays(log, device, idx)


def _resolve_loss(loss_name) -> Callable:
    return L.LOSSES[loss_name] if isinstance(loss_name, str) else loss_name


def train_step(params: C.Params, opt_state, batch, cfg: C.CascadeConfig,
               lcfg: L.LossConfig, loss_name, opt_update):
    """One SGD step on a dict of params: (params, opt_state, loss)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = _resolve_loss(loss_name)(leaves, cfg, lcfg, batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    updates, opt_state = opt_update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss.detach()


# ---------------------------------------------------------------------------
# Scan engine: the log packed on the device once, raveled params/momentum.
# ---------------------------------------------------------------------------

def _engine_pack(log: SearchLog, lcfg: L.LossConfig, precision: str = "f32",
                 device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Upload the log once, with param-independent loss terms precomputed.

    Returns (item (B, G, d_x+4), group (B, d_q+3)):
      item  = [x | y | mask | wgt | cost_w]   (`pack_items`)
      group = [q | m_q | mn | n_o_eff]
    With precision="bf16" the item array is stored in bfloat16."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown engine precision: {precision!r} "
                         "(expected 'f32' or 'bf16')")
    d = _log_arrays(log, device)
    wgt = L.importance_weights(d["behavior"], d["price"], lcfg)
    mn = d["m_q"] / torch.clamp_min(d["mask"].sum(-1), 1.0)
    base_w = (d["mask"] * (1.0 - d["y"]) if lcfg.cost_mask_positives
              else d["mask"])
    cost_w = base_w * mn[:, None]
    n_o_eff = torch.clamp_max(d["m_q"], lcfg.n_o)
    item = pack_items(d["x"], d["y"], d["mask"], wgt, cost_w)
    group = torch.cat([d["q"], d["m_q"][:, None], mn[:, None],
                       n_o_eff[:, None]], dim=-1)
    if precision == "bf16":
        item = item.to(torch.bfloat16)
    return item, group


def _engine_unpack(item: torch.Tensor, group: torch.Tensor,
                   d_x: int, d_q: int) -> dict[str, torch.Tensor]:
    """Packed minibatch -> the engine-batch dict the losses consume. Up-casts
    to f32 first (a no-op for f32 packs); the packed items ride along
    under "xc" for the fused L3 op."""
    item = item.float()
    group = group.float()
    return {
        "xc": item,
        "x": item[..., :d_x], "y": item[..., d_x],
        "mask": item[..., d_x + 1], "wgt": item[..., d_x + 2],
        "cost_w": item[..., d_x + 3],
        "q": group[..., :d_q], "m_q": group[..., d_q],
        "mn": group[..., d_q + 1], "n_o_eff": group[..., d_q + 2],
    }


def _ravel(params: C.Params) -> tuple[torch.Tensor, Callable]:
    """One vector of the params in key order (b, w_q, w_x — the order of
    the reference's ravel_pytree), and the map back to a dict of views."""
    keys = sorted(params)
    shapes = [params[k].shape for k in keys]
    sizes = [params[k].numel() for k in keys]
    theta = torch.cat([params[k].reshape(-1) for k in keys])

    def unravel(th: torch.Tensor) -> C.Params:
        return {k: p.view(s) for k, p, s in
                zip(keys, torch.split(th, sizes), shapes)}
    return theta, unravel


def _initial_params(cfg: C.CascadeConfig, tcfg: TrainConfig, init_params,
                    device) -> C.Params:
    if init_params is None:
        return C.init_params(cfg, torch.Generator().manual_seed(tcfg.seed),
                             device=device)
    return C.params_from_numpy(
        {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
         for k, v in init_params.items()}, device=device)


def _train_sig(tcfg: TrainConfig, cfg: C.CascadeConfig, n_groups: int) -> dict:
    """The run identity a checkpoint is only valid under (the reference's
    keys and values). Saved in every checkpoint's meta and strict-equality-
    checked on resume: resuming a trajectory under a different objective,
    optimizer or data order would silently produce a hybrid run."""
    return {
        "loss": tcfg.loss if isinstance(tcfg.loss, str) else "<custom>",
        "lr": tcfg.lr, "momentum": tcfg.momentum,
        "batch_groups": tcfg.batch_groups, "seed": tcfg.seed,
        "precision": tcfg.precision, "loss_scale": tcfg.loss_scale,
        "n_groups": n_groups, "d_x": cfg.d_x, "d_q": cfg.d_q,
        "n_stages": cfg.n_stages,
    }


def _prng_key(seed: int) -> np.ndarray:
    """The uint32 pair `jax.random.PRNGKey(seed)` gives for an int32 seed
    (the default threefry key, 64-bit mode off): the reference's
    checkpoints carry it as `rng_key`, so the port's do too."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _data_shard(mesh, batch_groups: int):
    """(rank, world size, process group) of the mesh's data axis; the
    minibatch's groups split into `world` contiguous blocks in rank order,
    as shard_map splits the reference's group axis."""
    world = mesh.size()
    if batch_groups % world:
        raise ValueError(f"batch_groups={batch_groups} must divide "
                         f"by the data-axis size {world}")
    return mesh.get_local_rank("data"), world, mesh.get_group("data")


@contextlib.contextmanager
def _one_thread_on_cpu(device: torch.device):
    """Run the block on one CPU thread when `device` is the CPU, and give
    the process its thread count back after it."""
    n = torch.get_num_threads()
    if device.type == "cpu":
        torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def fit(log: SearchLog, cfg: C.CascadeConfig, lcfg: L.LossConfig,
        tcfg: TrainConfig | None = None,
        callback: Callable[[int, float], None] | None = None,
        *, loss_fn: Callable | None = None, init_params=None,
        mesh=None, checkpoint_dir: str | None = None, resume: bool = False,
        keep_checkpoints: int = 3, crash_after_epoch: int | None = None,
        train_info: dict | None = None, device="cuda") -> C.Params:
    """Train CLOES params on the log on `device`. See the module docstring
    for the engines.

    loss_fn overrides the objective looked up from tcfg.loss.
    init_params (numpy arrays or tensors of the reference layout) sets the
    starting weights — the reference initialises from jax.random, which
    torch cannot replay, so a parity check passes the reference's initial
    weights here; without it the seeded `init_params` starts the fit.
    callback(step, loss) sees every log_every-th step's loss.

    mesh (scan engine only): a 1-D torch.distributed DeviceMesh with the
    dim "data" (`launch.mesh.data_parallel_mesh`); tcfg.batch_groups must
    divide by its size. Each rank takes its contiguous block of every
    minibatch's groups and normalizes its loss over that block (mask and
    m_q sums are per shard, as in the reference); gradients and the
    reported loss are all-reduced and divided by the world size before the
    (replicated) update — the gradient of the mean of per-shard losses,
    not of the global-batch loss, so a world of one is exact.

    checkpoint_dir (scan engine only) makes training crash-safe: every
    tcfg.checkpoint_every-th epoch (and the last) the state tree
    {"theta", "opt_state": {"step", "mu"}, "epoch", "rng_key"} — the
    reference's, theta and mu raveled in key order, step a 0-d int32 — is
    committed to a CheckpointStore by rank 0 alone (the store assumes one
    writer). resume=True restores the latest good checkpoint on every rank
    (falling back past torn ones); it wins over init_params, and the run
    continues bit-identically, because an epoch is a pure function of
    (theta, opt_state, epoch). A checkpoint written under a different
    TrainConfig identity is rejected (see _train_sig). crash_after_epoch
    hard-exits the process (os._exit(CRASH_EXIT_CODE), a SIGKILL
    stand-in) after that many epochs, once every rank is there — the
    deterministic crash seam of the restart smoke. train_info, when given,
    receives {"restored_epoch", "epochs_run"}.

    On a CPU device a fit takes its steps on one CPU thread (the
    process's thread count is restored when it returns): torch's
    multi-threaded CPU kernels do not give the same bits in every process
    (now and then a fresh process's fit differs from the others in the
    last bits), and a resumed run must reproduce the uninterrupted one,
    checkpointed or not, byte for byte. On the card nothing changes."""
    device = torch.device(device)
    with _one_thread_on_cpu(device):
        tcfg = tcfg or TrainConfig()
        params = _initial_params(cfg, tcfg, init_params, device)
        opt = momentum_sgd(tcfg.lr, tcfg.momentum)
        loss_fn = loss_fn or L.LOSSES[tcfg.loss]

        if tcfg.engine == "loop":
            if mesh is not None:
                raise ValueError("the loop engine has no data-parallel path")
            if checkpoint_dir is not None:
                raise ValueError(
                    "checkpointing is a scan-engine feature (the loop engine "
                    "is the no-moving-parts oracle)")
            if tcfg.precision != "f32" or tcfg.loss_scale != 1.0:
                raise ValueError(
                    "precision/loss_scale are scan-engine features (the loop "
                    "engine is the plain-f32 oracle); got "
                    f"precision={tcfg.precision!r}, "
                    f"loss_scale={tcfg.loss_scale}")
            opt_state = opt.init(params)
            step = 0
            for epoch in range(tcfg.epochs):
                for batch in batches(log, tcfg.batch_groups, tcfg.seed + epoch,
                                     device):
                    params, opt_state, loss = train_step(
                        params, opt_state, batch, cfg, lcfg, loss_fn,
                        opt.update)
                    if callback and step % tcfg.log_every == 0:
                        callback(step, float(loss))
                    step += 1
            return params
        if tcfg.engine != "scan":
            raise ValueError(f"unknown trainer engine: {tcfg.engine!r}")

        rank, world, group = 0, 1, None
        if mesh is not None:
            rank, world, group = _data_shard(mesh, tcfg.batch_groups)
        n_groups = log.x.shape[0]
        steps_per_epoch, _ = epoch_steps(n_groups, tcfg.batch_groups)
        if steps_per_epoch == 0:
            return params
        item, group_arr = _engine_pack(log, lcfg, tcfg.precision, device)
        theta, unravel = _ravel(params)
        opt_state = opt.init(theta)

        store = None
        start_epoch = 0
        if checkpoint_dir is not None:
            sig = _train_sig(tcfg, cfg, n_groups)
            ckpt_every = max(1, tcfg.checkpoint_every)
            store = CheckpointStore(checkpoint_dir, keep=keep_checkpoints)
            if resume:
                latest = store.load_latest()    # skips torn/corrupt steps
                if latest is not None:
                    _, state, meta = latest
                    saved_sig = (meta or {}).get("train_sig")
                    if saved_sig != sig:
                        raise ValueError(
                            "checkpoint was written under a different "
                            f"training config: saved {saved_sig} != "
                            f"current {sig}")
                    # exact restore: the bytes are crc-verified, so the
                    # resumed state IS the killed run's state. Copied into
                    # tensors of torch's own allocation: a CPU BLAS may take
                    # another path (and other sums) for a view of a numpy
                    # buffer of another alignment.
                    theta = torch.tensor(state["theta"], device=device)
                    opt_state = {
                        "step": int(state["opt_state"]["step"]),
                        "mu": torch.tensor(state["opt_state"]["mu"],
                                           device=device)}
                    start_epoch = int(state["epoch"])
        if train_info is not None:
            train_info["restored_epoch"] = start_epoch
            train_info["epochs_run"] = max(0, tcfg.epochs - start_epoch)

        shard = tcfg.batch_groups // world
        for epoch in range(start_epoch, tcfg.epochs):
            plan = _epoch_perm(n_groups, tcfg.batch_groups, tcfg.seed + epoch)
            idx = torch.as_tensor(plan[:, rank * shard:(rank + 1) * shard],
                                  device=device).reshape(-1)
            # one gather per packed array and epoch (of this rank's shard); a
            # bf16 pack is gathered in bf16 and up-cast here, once per epoch
            shape = (steps_per_epoch, shard)
            items = item[idx].reshape(*shape, *item.shape[1:]).float()
            groups = group_arr[idx].reshape(
                *shape, *group_arr.shape[1:]).float()
            losses = []
            for i in range(steps_per_epoch):
                batch = _engine_unpack(items[i], groups[i], cfg.d_x, cfg.d_q)
                th = theta.detach().requires_grad_(True)
                loss = loss_fn(unravel(th), cfg, lcfg, batch) * tcfg.loss_scale
                (grad,) = torch.autograd.grad(loss, th)
                loss = loss.detach()
                if tcfg.loss_scale != 1.0:
                    loss = loss / tcfg.loss_scale
                    grad = grad / tcfg.loss_scale
                if group is not None:
                    dist.all_reduce(grad, group=group)
                    dist.all_reduce(loss, group=group)
                    grad, loss = grad / world, loss / world
                updates, opt_state = opt.update(grad, opt_state, theta)
                theta = apply_updates(theta.detach(), updates)
                losses.append(loss)
            if callback:
                base = epoch * steps_per_epoch
                for i, v in enumerate(torch.stack(losses).tolist()):
                    if (base + i) % tcfg.log_every == 0:
                        callback(base + i, v)
            done = epoch + 1
            if rank == 0 and store is not None and (
                    done % ckpt_every == 0 or done == tcfg.epochs):
                store.save(done, {
                    "theta": theta,
                    # keys sorted, as the reference's jitted epoch returns them
                    "opt_state": {"mu": opt_state["mu"],
                                  "step": np.asarray(opt_state["step"],
                                                     np.int32)},
                    "epoch": done, "rng_key": _prng_key(tcfg.seed)},
                    meta={"train_sig": sig})
            if crash_after_epoch is not None and done >= crash_after_epoch:
                if group is not None:
                    dist.barrier(group=group)   # rank 0's save is committed
                os._exit(CRASH_EXIT_CODE)
        if group is not None and store is not None:
            dist.barrier(group=group)   # no rank returns before the last save
        return {k: v.clone() for k, v in unravel(theta).items()}


def evaluate(params: C.Params, cfg: C.CascadeConfig, log: SearchLog,
             lcfg: L.LossConfig | None = None) -> dict[str, float]:
    """Offline metrics on the params' device: AUC of the final score +
    expected cost per instance (Eq 8) + expected per-query latency (Eq 16)
    + final result size, all from ONE cascade forward."""
    lcfg = lcfg or L.LossConfig()
    device = params["w_x"].device
    d = _log_arrays(log, device)
    with torch.no_grad():
        lp, _ = L.cascade_forward(params, cfg, d["x"], d["q"])
        scores = lp[..., -1].cpu().numpy()
        cost = float(L.cost_from_lp(lp, cfg, d["mask"], m_q=d["m_q"]))
        counts = L.counts_from_lp(lp, d["mask"], d["m_q"])           # (B, T)
        lat = L.latency_from_counts_q(counts, d["m_q"], cfg,
                                      lcfg).cpu().numpy()
        counts_t = counts[:, -1].cpu().numpy()
    return {
        "auc": M.group_auc(scores, log.y, log.mask),
        "pooled_auc": M.auc(scores, log.y, log.mask),
        "expected_cost_per_item": cost,
        "mean_expected_latency": float(lat.mean()),
        "p95_expected_latency": float(np.percentile(lat, 95)),
        "mean_final_count": float(counts_t.mean()),
        "frac_queries_below_no": float(
            (counts_t < np.minimum(lcfg.n_o, log.m_q)).mean()),
    }
