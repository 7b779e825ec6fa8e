"""Device placement: serving replicas and the data-parallel training mesh.

Functions, never module-level constants, so importing this module never
touches CUDA or process-group state. The reference's
`make_production_mesh` (a 256- or 512-chip TPU pod mesh) has no analogue
on one card and is not ported.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


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
