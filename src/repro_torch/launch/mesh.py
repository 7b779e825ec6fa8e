"""Device placement for serving replicas.

A function, never a module-level constant, so importing this module never
touches CUDA state. The data-parallel half of the reference's
`launch/mesh.py` (a training mesh over devices) is not ported yet.
"""

from __future__ import annotations

import torch


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
