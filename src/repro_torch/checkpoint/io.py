"""Crash-safe pytree checkpointing: durable state for trainer and server,
ported from the reference's `checkpoint/io.py` with its on-disk format
unchanged, so each package reads the other's checkpoints.

  * `save_pytree(path, tree)` writes TWO files, `<path>.npz` (the arrays)
    and `<path>.json` (the manifest), each atomically: temp file in the
    same directory, flush + fsync, `os.replace`, then an fsync of the
    directory so the rename itself is durable. The manifest is written
    LAST — it is the commit point. A crash at any instant leaves either
    the previous checkpoint intact or an uncommitted temp/arrays file
    that loading ignores.
  * the manifest is versioned (`FORMAT_VERSION`) and carries a structure
    spec plus per-array {dtype, shape, crc32}; `load_pytree` verifies
    every checksum and the arrays-file length before decoding, so torn
    writes, truncation and bit rot surface as `CheckpointCorrupt`, never
    as silently wrong parameters.
  * the round trip is exact: dicts/lists/tuples come back as the same
    container types, Python scalars as Python scalars, numpy arrays and
    scalars as numpy arrays (0-d for a scalar). A torch tensor leaf is
    saved as its numpy array (`.detach().cpu()`, contiguous) and loads as
    numpy — except bfloat16, which numpy has no dtype for: it is stored as
    its uint16 bit pattern with `xdtype: "bfloat16"` in the manifest (the
    reference's encoding of its bf16 arrays) and loads as a torch bfloat16
    tensor with the same bits, whichever package wrote it.
  * `CheckpointStore` adds numbered steps on top: `save(step, tree,
    meta=)` commits `step_<n>`, retention GC keeps the newest `keep`
    committed steps, and `load_latest()` walks steps newest-first,
    skipping torn/corrupt ones (recorded in `store.errors`) until a
    checkpoint verifies — the last-good fallback the restart path relies
    on. An optional `FsFaultInjector` (serving.faults) wraps every file
    write/read so that discipline is chaos-tested.

Nothing is pickled: arrays go through `np.savez` and load with
`allow_pickle=False`.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch

FORMAT = "repro-checkpoint"
FORMAT_VERSION = 1

_ARRAYS_SUFFIX = ".npz"
_MANIFEST_SUFFIX = ".json"
_BF16 = "bfloat16"


class CheckpointError(RuntimeError):
    """Base class for checkpoint load failures."""


class CheckpointCorrupt(CheckpointError):
    """The checkpoint on disk is torn, truncated, or bit-rotted: a
    checksum/length/parse check failed. load_latest() treats this as
    'skip and fall back to the previous step'."""


# ---------------------------------------------------------------------------
# Structure spec: a JSON-serializable exact encoding of the pytree. Tags:
#   {"d": [[key, spec], ...]}  dict (string keys, insertion order kept)
#   {"l": [spec, ...]}         list
#   {"t": [spec, ...]}         tuple
#   {"a": idx}                 array leaf -> arrays entry `a<idx>`
#   {"=": value}               Python scalar leaf (int/float/bool/str/None)
# ---------------------------------------------------------------------------

def _leaf_array(node) -> tuple[np.ndarray, str | None]:
    """(the array npz stores, the real dtype's name when npz stores its
    bits instead)."""
    if isinstance(node, torch.Tensor):
        t = node.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), None
    # np.asarray(order="C") forces contiguity without the 0-d -> (1,)
    # promotion np.ascontiguousarray does
    a = np.asarray(node, order="C")
    if a.dtype.isbuiltin != 1:
        # np.savez would silently degrade a non-native dtype (ml_dtypes'
        # bfloat16, fp8) to raw void bytes; bf16 comes as a torch tensor
        raise TypeError(
            f"unsupported checkpoint leaf dtype {a.dtype.name}: pass a "
            "bfloat16 array as a torch tensor")
    return a, None


def _encode(node, arrays: dict, meta: list):
    if isinstance(node, dict):
        pairs = []
        for k, v in node.items():
            if not isinstance(k, str):
                raise TypeError(
                    f"checkpoint dict keys must be strings, got {k!r} "
                    f"({type(k).__name__})")
            pairs.append([k, _encode(v, arrays, meta)])
        return {"d": pairs}
    if isinstance(node, (list, tuple)):
        kids = [_encode(v, arrays, meta) for v in node]
        return {"l": kids} if isinstance(node, list) else {"t": kids}
    if isinstance(node, (np.ndarray, np.generic, torch.Tensor)):
        a, xdtype = _leaf_array(node)
        idx = len(meta)
        arrays[f"a{idx}"] = a
        meta.append({"dtype": a.dtype.str, "xdtype": xdtype,
                     "shape": list(a.shape),
                     "crc32": zlib.crc32(a.tobytes())})
        return {"a": idx}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"=": node}
    raise TypeError(f"unsupported checkpoint leaf: {type(node).__name__}")


def _decode(spec, data, meta):
    if "d" in spec:
        return {k: _decode(s, data, meta) for k, s in spec["d"]}
    if "l" in spec:
        return [_decode(s, data, meta) for s in spec["l"]]
    if "t" in spec:
        return tuple(_decode(s, data, meta) for s in spec["t"])
    if "a" in spec:
        idx = spec["a"]
        m = meta[idx]
        key = f"a{idx}"
        if key not in data:
            raise CheckpointCorrupt(f"arrays file is missing {key}")
        a = data[key]
        if a.dtype.str != m["dtype"] or list(a.shape) != m["shape"]:
            raise CheckpointCorrupt(
                f"array {key} does not match its manifest: "
                f"{a.dtype.str}{a.shape} != {m['dtype']}{tuple(m['shape'])}")
        if zlib.crc32(a.tobytes()) != m["crc32"]:
            raise CheckpointCorrupt(
                f"array {key} failed its checksum (torn write or bit rot)")
        if m["xdtype"] == _BF16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        if m["xdtype"] is not None:
            raise CheckpointError(
                f"array {key} is stored as {m['xdtype']}, which this reader "
                "cannot restore (it restores bfloat16 only)")
        return a
    return spec["="]


# ---------------------------------------------------------------------------
# Atomic file IO. fs_faults (serving.faults.FsFaultInjector) wraps the raw
# bytes on the way to/from disk so the fallback path is chaos-testable.
# ---------------------------------------------------------------------------

def _atomic_write(path: Path, payload: bytes, fs_faults=None) -> None:
    """temp file + flush + fsync + rename + directory fsync: after this
    returns (or after a crash at any point inside it) the path holds
    either the complete new payload or whatever it held before — never a
    prefix. An injected torn write (fs_faults) deliberately commits a
    prefix, modeling a filesystem that lied about durability; the
    checksum layer must catch it on read."""
    if fs_faults is not None:
        payload = fs_faults.on_write(str(path), payload)
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(path.parent, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def _read_bytes(path: Path, fs_faults=None) -> bytes:
    payload = path.read_bytes()
    if fs_faults is not None:
        payload = fs_faults.on_read(str(path), payload)
    return payload


def save_pytree(path: str | Path, tree, *, meta: dict | None = None,
                fs_faults=None) -> Path:
    """Write `tree` crash-safely as `<path>.npz` + `<path>.json`.

    Arrays first, manifest last: the manifest is the commit point, so a
    crash mid-save leaves the checkpoint uncommitted (manifest absent or
    stale) rather than half-written. `meta` is an optional JSON-
    serializable dict stored in the manifest (retrieved by
    `CheckpointStore.load` / `load_latest`)."""
    base = Path(path)
    base.parent.mkdir(parents=True, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    ameta: list[dict] = []
    spec = _encode(tree, arrays, ameta)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    npz_bytes = buf.getvalue()
    manifest = {
        "format": FORMAT, "version": FORMAT_VERSION,
        "spec": spec, "arrays": ameta, "npz_bytes": len(npz_bytes),
        "meta": meta,
    }
    _atomic_write(base.with_name(base.name + _ARRAYS_SUFFIX), npz_bytes,
                  fs_faults)
    _atomic_write(base.with_name(base.name + _MANIFEST_SUFFIX),
                  json.dumps(manifest).encode(), fs_faults)
    return base


def _load(base: Path, fs_faults=None) -> tuple[object, dict | None]:
    """Verify and decode one checkpoint. FileNotFoundError when it was
    never committed (no manifest); CheckpointCorrupt when any integrity
    check fails; CheckpointError for a format/version we cannot read."""
    man_path = base.with_name(base.name + _MANIFEST_SUFFIX)
    raw = _read_bytes(man_path, fs_faults)      # FileNotFoundError -> caller
    try:
        man = json.loads(raw.decode())
    except ValueError as e:
        # json.JSONDecodeError and UnicodeDecodeError are both ValueError —
        # the only failure modes of decoding bytes we already read in full
        raise CheckpointCorrupt(f"manifest {man_path.name} unreadable: {e}")
    if not isinstance(man, dict) or man.get("format") != FORMAT:
        raise CheckpointCorrupt(
            f"{man_path.name} is not a {FORMAT} manifest")
    if man.get("version", 0) > FORMAT_VERSION:
        raise CheckpointError(
            f"checkpoint version {man['version']} is newer than this "
            f"reader (supports <= {FORMAT_VERSION})")
    npz_path = base.with_name(base.name + _ARRAYS_SUFFIX)
    try:
        npz_raw = _read_bytes(npz_path, fs_faults)
    except FileNotFoundError:
        raise CheckpointCorrupt(
            f"manifest present but arrays file {npz_path.name} missing "
            "(torn checkpoint)")
    if len(npz_raw) != man["npz_bytes"]:
        raise CheckpointCorrupt(
            f"arrays file {npz_path.name} is {len(npz_raw)} bytes, "
            f"manifest committed {man['npz_bytes']} (truncated)")
    try:
        with np.load(io.BytesIO(npz_raw), allow_pickle=False) as data:
            arrays = {k: data[k] for k in data.files}
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        # np.load failure modes on in-memory corrupt bytes: bad npy magic /
        # header (ValueError), zip directory or member CRC damage
        # (BadZipFile), a member the header promised but the zip lacks
        # (KeyError), stream errors (OSError)
        raise CheckpointCorrupt(f"arrays file {npz_path.name} unreadable: {e}")
    tree = _decode(man["spec"], arrays, man["arrays"])
    return tree, man.get("meta")


def load_pytree(path: str | Path, *, fs_faults=None):
    """Load and VERIFY a checkpoint written by save_pytree (by either
    package). Raises FileNotFoundError if it was never committed and
    CheckpointCorrupt if any checksum/length/parse check fails — corrupt
    state is never silently returned."""
    tree, _ = _load(Path(path), fs_faults)
    return tree


# ---------------------------------------------------------------------------
# Numbered checkpoint steps with retention and last-good fallback.
# ---------------------------------------------------------------------------

class CheckpointStore:
    """Crash-safe numbered checkpoints in one directory.

    `save(step, tree, meta=)` commits `step_<n>` atomically then GCs down
    to the newest `keep` committed steps. `load_latest()` walks committed
    steps newest-first and returns the first one that passes verification
    — a torn or bit-rotted newest checkpoint falls back to the previous
    good one (each skip is recorded in `self.errors`). Single writer
    assumed (the trainer's rank 0 / the serving launcher); readers are
    safe any time because commits are atomic."""

    def __init__(self, directory: str | Path, *, keep: int = 3,
                 fs_faults=None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dir = Path(directory)
        self.keep = keep
        self.fs_faults = fs_faults
        self.errors: list[tuple[int, str]] = []   # (step, why skipped)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _base(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def steps(self) -> list[int]:
        """Committed step numbers (manifest present), ascending. Temp
        files and orphaned arrays files are not steps."""
        out = []
        for p in self.dir.glob(f"step_*{_MANIFEST_SUFFIX}"):
            stem = p.name[:-len(_MANIFEST_SUFFIX)]
            try:
                out.append(int(stem.split("_", 1)[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree, *, meta: dict | None = None) -> Path:
        base = save_pytree(self._base(step), tree, meta=meta,
                           fs_faults=self.fs_faults)
        self.gc()
        return base

    def load(self, step: int) -> tuple[object, dict | None]:
        return _load(self._base(step), self.fs_faults)

    def load_latest(self) -> tuple[int, object, dict | None] | None:
        """Newest verifiable checkpoint as (step, tree, meta), falling
        back past torn/corrupt steps; None when nothing loads."""
        for step in reversed(self.steps()):
            try:
                tree, meta = self.load(step)
                return step, tree, meta
            except (CheckpointError, FileNotFoundError, OSError) as e:
                self.errors.append((step, f"{type(e).__name__}: {e}"))
        return None

    def gc(self) -> list[int]:
        """Delete all but the newest `keep` committed steps (manifest
        first so a crash mid-GC leaves an ignorable orphan, not a
        manifest pointing at deleted arrays) plus any stale temp files.
        Returns the steps removed."""
        steps = self.steps()
        dead = steps[:-self.keep] if len(steps) > self.keep else []
        for step in dead:
            base = self._base(step)
            base.with_name(base.name + _MANIFEST_SUFFIX).unlink(
                missing_ok=True)
            base.with_name(base.name + _ARRAYS_SUFFIX).unlink(
                missing_ok=True)
        for tmp in self.dir.glob("*.tmp.*"):
            tmp.unlink(missing_ok=True)
        return dead
