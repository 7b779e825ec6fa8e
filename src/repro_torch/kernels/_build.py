"""Build and load the port's CUDA C++ kernels.

Every `csrc/*.cu` source is compiled by `nvcc` for sm_90a (one process per
source, all started together), the objects are linked into one shared
library with a plain C interface, and the library is loaded with `ctypes`.
The library lands in `build/repro_torch/<hash>/` at the repository root,
keyed by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the existing library. Nothing is built when a module
is imported: the first call that launches a kernel builds it (the serving
session's `warmup()` makes that call, before any request is timed).

Shared checks for the kernel wrappers live here too: a wrapper takes only
contiguous tensors of the dtypes its kernel reads — float32 for K1-K5
(the batched cascade kernels), float32 or bfloat16 for K6 and K7 (the
single-group and feature-major scorers, which up-cast bf16 inputs in
registers as the reference's kernels do) and for K8 (`swa_decode`, which
reads a bf16 KV cache as it is) — on one CUDA device of compute
capability 9.0, and raises on anything else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("cascade_score.cu", "cascade_filter.cu", "cascade_score_bwd.cu",
           "cascade_loss.cu", "swa_decode.cu", "cascade_score_single.cu")
HEADERS = ("common.cuh", "ordered_sum.cuh",    # included; part of the key
           "warp_ring.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libcascade_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
MAX_SMEM_BYTES = 232_448       # per-block shared memory limit on sm_90
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", f"-DREPRO_MAX_SMEM_BYTES={MAX_SMEM_BYTES}")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: (argtypes, restype)
    "cascade_score_batched": ([_P] * 4 + [_I] * 4 + [_P], _I),
    "cascade_score_batched_smem": ([_I, _I], ctypes.c_size_t),
    "cascade_filter": ([_P] * 9 + [_I] * 4 + [_P], _I),
    "cascade_filter_smem": ([_I, _I, _I], ctypes.c_size_t),
    "cascade_score_batched_bwd": ([_P] * 8 + [_I] * 4 + [_P], _I),
    "cascade_score_bwd_smem": ([_I, _I], ctypes.c_size_t),
    "cascade_loss": ([_P] * 7 + [_I] * 4 + [_P], _I),
    "cascade_loss_smem": ([_I, _I], ctypes.c_size_t),
    "cascade_loss_bwd": ([_P] * 11 + [_I] * 4 + [_P], _I),
    "cascade_loss_bwd_smem": ([_I, _I], ctypes.c_size_t),
    "swa_decode": ([_P] * 8 + [_I] * 11 + [_F, _P], _I),
    "swa_decode_blocks_per_sm": ([_I, _I, _I], _I),
    "swa_decode_tile": ([_I, _I], _I),
    "cascade_score_groups": ([_P] * 4 + [_I] * 6 + [_P], _I),
    "cascade_score_groups_smem": ([_I] * 3, ctypes.c_size_t),
    "cascade_score_fm": ([_P] * 4 + [_I] * 4 + [_P], _I),
    "cascade_score_fm_smem": ([_I, _I], ctypes.c_size_t),
    "cascade_score_groups_bwd": ([_P] * 7 + [_I] * 7 + [_P], _I),
    "cascade_score_groups_bwd_smem": ([_I] * 3, ctypes.c_size_t),
    "cascade_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Guards every wrapper's `.launches` count: serving threads (a pump per
# replica) launch kernels at once, and `+= 1` on an attribute is a
# read-modify-write that would lose increments between them.
launch_lock = threading.Lock()
# What the last build (or load) did: library path, seconds spent, and the
# compiler's output (ptxas register / shared-memory report per kernel).
build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "CUDA kernels are built from csrc/ on first use")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources into the hashed build directory (a no-op when
    the library for these sources is already there); return its path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_info.update(path=str(lib), seconds=0.0, log="(cached)")
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    logs = []
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{name}.o" for name in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(SOURCES, objs)]
        try:
            for name, p in zip(SOURCES, procs):
                out, _ = p.communicate()
                logs.append(f"== {name}\n{out}")
                if p.returncode:
                    raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-Xcompiler", "-fPIC",
             *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link\n{link.stdout}")
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    log = "\n".join(logs)
    (out_dir / "build.log").write_text(log)
    build_info.update(path=str(lib), seconds=time.perf_counter() - t0,
                      log=log)
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, built on the first call and loaded once per
    process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches`, under `launch_lock`: the one place a
    wrapper counts the kernel it has just launched."""
    with launch_lock:
        wrapper.launches += 1


def check_launch(lib: ctypes.CDLL, op: str, rc: int) -> None:
    """Raise when a kernel's C entry point reports a CUDA error."""
    if rc != 0:
        msg = lib.cascade_error_string(rc).decode()
        raise RuntimeError(f"{op}: kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def check_inputs(op: str, dtypes: tuple[torch.dtype, ...] = (torch.float32,),
                 **tensors: torch.Tensor) -> torch.device:
    """The kernels take contiguous tensors of `dtypes` (float32 unless the
    kernel says otherwise) on one CUDA device of compute capability 9.0;
    raise on anything else. Returns the device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{op}: inputs on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type != "cuda":
        raise ValueError(f"{op}: the CUDA kernel needs CUDA tensors, got {device}")
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"{op}: the kernel is built for sm_90a (H100/H200); "
            f"{torch.cuda.get_device_name(device)} is sm_{cap[0]}{cap[1]}")
    for name, t in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{op}: {name} must be "
                            f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    return device


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
