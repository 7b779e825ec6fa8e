"""Crash-safe pytree checkpointing (atomic npz + checksummed manifest, the
reference's on-disk format — see io.py for the commit protocol)."""

from repro_torch.checkpoint.io import (
    CheckpointCorrupt,
    CheckpointError,
    CheckpointStore,
    load_pytree,
    save_pytree,
)

__all__ = ["save_pytree", "load_pytree", "CheckpointStore",
           "CheckpointError", "CheckpointCorrupt"]
