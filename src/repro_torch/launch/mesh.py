"""Device placement: the entry points' device, serving replicas, the
data-parallel training mesh, and the model-parallel runs.

Functions, never module-level constants, so importing this module never
touches CUDA or process-group state. A mesh description (`MeshShape`: axis
names and sizes, no devices) stands for the reference's meshes where the
layout rules (`launch/sharding.py`) need one: `production_mesh` is the
reference's `make_production_mesh` shape (a 256- or 512-chip pod), and
`model_mesh(world)` the ("data", "model") mesh of a model-parallel run of
`world` ranks, which `model_parallel` joins and `spawn_ranks` starts;
`train_mesh(data, model)` that of a training run over data x model ranks.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import queue
import tempfile
import time
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# the reference's mesh.data_axes, kept beside the layout rules
from repro_torch.launch.sharding import data_axes  # noqa: F401
from repro_torch.models.parallel import ModelParallel


def device_of(device) -> torch.device:
    """`device` as a torch.device; asking for CUDA without a card raises
    (an entry point never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "(device='cpu') to run on the CPU")
    return dev


def data_parallel_mesh(batch_groups: int, device_type: str = "cuda"):
    """1-D ("data",) DeviceMesh over the ranks of the default process group
    for CLOES training (`core.trainer.fit(mesh=...)`).

    Uses the largest world size that divides batch_groups (each rank takes
    an equal contiguous block of every minibatch's groups): the mesh holds
    ranks 0..n-1, and a rank outside it gets `get_coordinate() is None`.
    Returns None without an initialised process group or when that size
    is 1 — the trainer then takes its plain path. Every rank of the group
    must call it (it creates the mesh's process groups)."""
    if not dist.is_initialized():
        return None
    n = dist.get_world_size()
    while n > 1 and batch_groups % n:
        n -= 1
    if n <= 1:
        return None
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=("data",))


def replica_devices(n: int, kind: str = "cuda") -> list[torch.device]:
    """One device per serving replica, round-robin over the local CUDA
    cards (serving.router.make_replicas). On a one-card machine every
    replica is `cuda:0`, and make_replicas gives each its own stream of
    that card. `kind="cpu"` places every replica on the CPU (the kernels'
    plain versions). Asking for CUDA without a card raises."""
    if kind == "cpu":
        return [torch.device("cpu")] * n
    if kind != "cuda":
        raise ValueError(f"replica devices of kind {kind!r}: expected "
                         "'cuda' or 'cpu'")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("replica_devices: no CUDA card is visible")
    return [torch.device("cuda", k % count) for k in range(n)]


# ---------------------------------------------------------------------------
# Mesh descriptions and model-parallel runs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices: what the layout
    rules read (`.shape` maps axis name to size, as a jax Mesh's does)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh: (data=16, model=16), 256 chips a
    pod; multi-pod adds a leading pod axis (2 pods = 512 chips)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def model_mesh(world: int) -> MeshShape:
    """The mesh of a model-parallel run of `world` ranks: one data row,
    the ranks along "model"."""
    return MeshShape(("data", "model"), (1, world))


def train_mesh(data: int, model: int) -> MeshShape:
    """The ("data", "model") mesh of a training run of data x model ranks
    (`zoo.train_step` with a `parallel.TrainLayout`): the batch cut over
    "data", the layout's cuts over both."""
    return MeshShape(("data", "model"), (data, model))


def model_axis(mesh) -> str:
    return "model"


def transport(world: int, device) -> tuple[str, list[torch.device]]:
    """(backend, each rank's device) of a model-parallel run of `world`
    ranks on `device`'s kind: NCCL with one card a rank when the machine
    has a card for every rank; gloo when ranks share cards (rank r on card
    r mod the cards: NCCL refuses two ranks on one device, gloo moves CUDA
    tensors through the host) or run on the CPU. Asking for CUDA without a
    card raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo", [dev] * world
    if dev.type != "cuda":
        raise ValueError(f"model-parallel ranks on {dev.type!r}: expected "
                         "'cuda' or 'cpu'")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("model_parallel: no CUDA card is visible")
    if count >= world:
        return "nccl", [torch.device("cuda", r) for r in range(world)]
    return "gloo", [torch.device("cuda", r % count) for r in range(world)]


def model_parallel(world: int, device, *, rank: int, init_method: str,
                   timeout_s: float = 600.0,
                   mesh: MeshShape | None = None) -> ModelParallel:
    """Join rank `rank` of a model-parallel run of `world` ranks on the
    ("data", "model") `mesh` (default `model_mesh(world)`; ranks numbered
    row-major): pick the transport (`transport`), bind this process to its
    device (on the CPU: one torch thread), initialise the default process
    group at `init_method` (collectives time out after timeout_s), create
    a process group for each row and each column of the mesh where both
    axes have more than one rank (every rank creates every group, in the
    same order) and return its ModelParallel. Rank 0 prints the choice. A
    failing transport raises: there is no fallback to the other one."""
    mesh = model_mesh(world) if mesh is None else mesh
    if tuple(mesh.axis_names) != ("data", "model") or mesh.size != world:
        raise ValueError(f"a run of {world} ranks on a (\"data\", "
                         f"\"model\") mesh, not {mesh}")
    backend, devices = transport(world, device)
    dev = devices[rank]
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    n_data, n_model = mesh.sizes
    groups = {}
    if n_data > 1 and n_model > 1:
        for d in range(n_data):
            groups[("row", d)] = dist.new_group(
                [d * n_model + m for m in range(n_model)])
        for m in range(n_model):
            groups[("col", m)] = dist.new_group(
                [d * n_model + m for d in range(n_data)])
    data_rank, model_rank = divmod(rank, n_model)
    if rank == 0:
        cards = sorted({str(d) for d in devices})
        print(f"[model parallel] {world} ranks"
              + (f" (data {n_data} x model {n_model})" if n_data > 1 else "")
              + f" over {backend} on {', '.join(cards)}"
              + (" (the ranks share the card)" if dev.type == "cuda"
                 and len(cards) < world else ""), flush=True)
    return ModelParallel(rank=model_rank, world=n_model, mesh=mesh,
                         backend=backend, device=dev, data_rank=data_rank,
                         data_world=n_data,
                         model_group=groups.get(("row", data_rank)),
                         data_group=groups.get(("col", model_rank)))


def _to_host(value):
    """A rank's result with every tensor as a numpy array (bfloat16 as
    float32, which holds it exactly), so it crosses to the parent by
    value."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    return value


def _rank_main(rank, world, device, init_method, timeout_s, fn, args,
               results, mesh) -> None:
    mp = model_parallel(world, device, rank=rank, init_method=init_method,
                        timeout_s=timeout_s, mesh=mesh)
    try:
        value = _to_host(fn(mp, *args))
    finally:
        dist.destroy_process_group()
    results.put((rank, value))


def spawn_ranks(world: int, fn: Callable, args: tuple = (), *,
                device="cuda", timeout_s: float = 600.0,
                mesh: MeshShape | None = None) -> list[Any]:
    """Run fn(mp, *args) in `world` spawned processes, one rank each, each
    with its ModelParallel `mp` (`model_parallel` on `mesh`, default
    `model_mesh(world)`; the group meets at a file under a temporary
    directory), and return their results in rank order, tensors as numpy
    arrays. The ranks run on the card unless `device` asks for the CPU
    (`device_of`: without a card "cuda" raises here, before any rank
    starts). `fn` and `args` must pickle (fn a
    module-level function). A rank that exits without a result, or no
    result within timeout_s, raises RuntimeError naming the rank (its
    traceback is on its stderr); every rank still running is then
    terminated."""
    device = device_of(device)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, str(device),
                                   f"file://{tmp}/init", timeout_s, fn,
                                   args, results, mesh))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            out: dict[int, Any] = {}
            deadline = time.monotonic() + timeout_s
            while len(out) < world:
                try:
                    rank, value = results.get(timeout=1.0)
                    out[rank] = value
                    continue
                except queue.Empty:
                    pass
                failed = [r for r, p in enumerate(procs)
                          if r not in out and p.exitcode is not None]
                if failed:
                    # a result may have landed just before its rank exited
                    time.sleep(1.0)
                    while not results.empty():
                        rank, value = results.get()
                        out[rank] = value
                    failed = [r for r in failed if r not in out]
                if failed:
                    raise RuntimeError(
                        f"model-parallel ranks {failed} of {world} exited "
                        f"without a result (exit codes "
                        f"{[procs[r].exitcode for r in failed]})")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"model-parallel ranks gave no result "
                                       f"within {timeout_s} s")
            for p in procs:
                p.join(timeout=60)
            return [out[r] for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
