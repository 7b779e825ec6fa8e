#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the CUDA kernels from `src/repro_torch/csrc` (nvcc,
   sm_90a) and loads them;
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, at every shape the serving session warms and at edge shapes
   (ties, fully masked groups, m_q > G); continuous outputs at rtol/atol
   1e-5, discrete outputs exactly, after checking that the inputs leave
   every discrete decision a margin (kernels/cascade_filter/ref.py);
4. timing: each kernel and its plain version at B=4096 groups of G=256
   items (d=24, T=3): the median over 25 runs of 20 calls back to back
   between CUDA events (device time per call), beside a lone call's time
   (wrapper and launch included) and the least time the card could take
   (bytes at 3.35 TB/s, operations at 67 TFLOP/s f32);
5. the slice: the launcher's open-loop DES (`launch.serve`) on the card,
   once per plan ("filter", then "score"): 500 requests of 8-63 items at
   400 QPS with a 130 ms deadline, checked for resolved futures, closed
   accounting, no faults or errors, no shape first seen after warmup, the
   plan's kernel launched once per served chunk, and responses that agree
   with the plain pipeline on the CPU;
6. one JSON line with each kernel's launches on the main path, error and
   times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import cloes  # noqa: E402
from repro_torch.core import pipeline as P  # noqa: E402
from repro_torch.data import LogConfig, generate_log  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.cascade_filter.ref import (  # noqa: E402
    assert_decision_margin)
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.serving.batching import (alloc_batch, bucket_of,  # noqa: E402
                                          pack_into)
from repro_torch.serving.loadgen import run_open_loop  # noqa: E402

RTOL = ATOL = 1e-5          # float32 sums taken in another order
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
WARM_B = (1, 2, 4, 8, 16, 32)
WARM_G = (16, 64, 256)
TIMING_SHAPE = (4096, 256, 24, 3)     # B, G, d, T: ~100 MB of x
DES_REQUESTS, DES_QPS, DES_DEADLINE_MS = 500, 400.0, 130.0
BUSY_CYCLES = 50_000_000    # ~25 ms at 1.98 GHz: covers queueing the calls

KERNEL_INFO = {
    "cascade_score_batched": {
        "route": "cuda", "source": "src/repro_torch/csrc/cascade_score.cu",
        "replaces": "src/repro/kernels/cascade_score/kernel.py:238"},
    "cascade_filter": {
        "route": "cuda", "source": "src/repro_torch/csrc/cascade_filter.cu",
        "replaces": "src/repro/kernels/cascade_filter/kernel.py:111"},
}


def sync():
    torch.cuda.synchronize()


# -- 1. device ----------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} "
          f"sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# -- 2. build -----------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    ops.load_library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f}s -> {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build]   {line.strip()}")


# -- 3. kernels vs plain --------------------------------------------------------

def make_case(b, g, d, t, seed, *, twins=False, masked_group=None,
              mq_big=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, g, d))
    if twins:                       # every item has an identical twin
        x[:, 1::2] = x[:, ::2][:, :g // 2]
    w = 0.3 * rng.normal(size=(t, d))
    zq = np.full((b, t), 8.0) if mq_big else rng.normal(size=(b, t))
    mask = (rng.random((b, g)) < 0.85).astype(np.float32)
    if twins or mq_big:
        mask[:] = 1.0
    if masked_group is not None:
        mask[masked_group] = 0.0
    m_q = np.full(b, 1e6) if mq_big else rng.integers(1, 4 * g + 2, b)
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    return dev(x), dev(w), dev(zq), dev(mask), dev(m_q)


def case_with_margin(b, g, d, t, seed, **kw):
    """The first seed from `seed` on whose inputs every discrete decision
    of the plain filter has margin."""
    last = None
    for s in range(seed, seed + 50):
        case = make_case(b, g, d, t, s, **kw)
        lp = ops.cascade_score_batched_ref(*case[:3])
        try:
            assert_decision_margin(lp, case[3], case[4])
            return case
        except AssertionError as e:
            last = e
    raise AssertionError(f"no seed with decision margin for {(b, g, d, t)}: "
                         f"{last}")


def check_case(case, errs, label):
    x, w, zq, mask, m_q = case
    got = ops.cascade_score_batched(x, w, zq)
    sync()
    want = ops.cascade_score_batched_ref(x, w, zq)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                               msg=lambda m: f"K1 {label}: {m}")
    errs["cascade_score_batched"] = max(
        errs["cascade_score_batched"], float((got - want).abs().max()))
    got = ops.cascade_filter(x, w, zq, mask, m_q)
    sync()
    want = ops.cascade_filter_ref(x, w, zq, mask, m_q)
    for k in ("lp", "expected_counts"):
        torch.testing.assert_close(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"K2 {label} {k}: {m}")
        errs["cascade_filter"] = max(errs["cascade_filter"],
                                     float((got[k] - want[k]).abs().max()))
    for k in ("n_keep", "survivors"):
        if not torch.equal(got[k], want[k]):
            bad = (got[k] != want[k]).nonzero()[:5].tolist()
            raise AssertionError(f"K2 {label}: {k} differs from the plain "
                                 f"version at {bad}")
    return got


def phase_parity() -> dict[str, float]:
    errs = {"cascade_score_batched": 0.0, "cascade_filter": 0.0}
    n = 0
    for g in WARM_G:
        for b in WARM_B:
            check_case(case_with_margin(b, g, 24, 3, seed=1000 * g + b),
                       errs, f"warm shape b={b} g={g}")
            n += 1
    for b, g, d, t in [(4, 1, 24, 3), (4, 7, 24, 3), (4, 130, 24, 3),
                       (4, 512, 24, 3), (8, 64, 8, 1), (8, 64, 40, 5),
                       (8, 64, 24, 8), (4, 512, 40, 8), (3, 33, 8, 5)]:
        check_case(case_with_margin(b, g, d, t, seed=g * 37 + d + t),
                   errs, f"b={b} g={g} d={d} t={t}")
        n += 1
    got = check_case(case_with_margin(3, 64, 24, 3, seed=0, twins=True),
                     errs, "ties")
    kept = got["survivors"][..., -1].sum().item()
    assert 0 < kept < 3 * 64, f"tie case kept {kept} of 192"
    got = check_case(case_with_margin(3, 32, 24, 3, seed=1, masked_group=1),
                     errs, "fully masked group")
    assert got["survivors"][1].sum().item() == 0
    assert (got["n_keep"][1] == 1).all()
    got = check_case(case_with_margin(2, 16, 24, 2, seed=2, mq_big=True),
                     errs, "m_q > G")
    assert (got["n_keep"] == 16).all()
    assert (got["survivors"][..., -1] == 1).all()
    n += 3
    print(f"[parity] {n} cases: kernels agree with their plain versions "
          f"(max |err| K1 {errs['cascade_score_batched']:.3g}, "
          f"K2 {errs['cascade_filter']:.3g}; discrete outputs exact)")
    return errs


# -- 4. timing ------------------------------------------------------------------

def time_ms(fn, reps=25, calls=20) -> tuple[float, float]:
    """(device ms per call, ms per lone call), medians over `reps`.

    Device time: `calls` calls back to back between one pair of CUDA
    events, queued behind a busy-wait on the stream, so the host's
    wrapper work overlaps device work and the events see only the
    device's time. A lone call is one call from an idle stream between
    two events: the wrapper's host time up to the launch is inside it."""
    for _ in range(3):
        fn()
    sync()
    device, lone = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(BUSY_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        z.record()
        z.synchronize()
        device.append(a.elapsed_time(z) / calls)
        a.record()
        fn()
        z.record()
        z.synchronize()
        lone.append(a.elapsed_time(z))
    return statistics.median(device), statistics.median(lone)


def phase_timing() -> dict[str, dict]:
    b, g, d, t = TIMING_SHAPE
    x, w, zq, mask, m_q = make_case(b, g, d, t, seed=7)
    f = 4  # bytes per float32
    out = {}
    # K1: read x, w, zq once; write lp once.
    k1_bytes = f * (b * g * d + t * d + b * t + b * g * t)
    k1_ops = 2 * b * g * t * d
    kern, lone = time_ms(lambda: ops.cascade_score_batched(x, w, zq))
    plain, _ = time_ms(lambda: ops.cascade_score_batched_ref(x, w, zq))
    out["cascade_score_batched"] = dict(
        ms=kern, lone_ms=lone, plain_ms=plain, bytes=k1_bytes, ops=k1_ops)
    # K2: read x, w, zq, mask, m_q; write lp, survivors, counts, n_keep.
    # Operations: the scores, plus one compare and one add per (item,
    # surviving item) pair in each stage, counted on this run's survivors.
    res = ops.cascade_filter(x, w, zq, mask, m_q)
    entering = torch.cat([mask[..., None], res["survivors"][..., :-1]], -1)
    pairs = int(entering.sum().item()) * g
    k2_bytes = f * (b * g * d + t * d + b * t + b * g + b
                    + 2 * b * g * t + 2 * b * t)
    k2_ops = 2 * b * g * t * d + 2 * pairs
    kern, lone = time_ms(lambda: ops.cascade_filter(x, w, zq, mask, m_q))
    plain, _ = time_ms(lambda: ops.cascade_filter_ref(x, w, zq, mask, m_q))
    out["cascade_filter"] = dict(ms=kern, lone_ms=lone, plain_ms=plain,
                                 bytes=k2_bytes, ops=k2_ops, pairs=pairs)
    for name, r in out.items():
        by_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        by_ops = r["ops"] / F32_OPS_PER_S * 1e3
        r["bound_ms"] = max(by_bytes, by_ops)
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        print(f"[timing] {name} at B={b} G={g} d={d} T={t}: kernel "
              f"{r['ms']:.4f} ms (a lone call from an idle stream "
              f"{r['lone_ms']:.4f} ms: {r['lone_ms'] - r['ms']:.4f} ms of "
              f"wrapper and launch), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bytes']} "
              f"bytes -> {by_bytes:.4f} ms; {r['ops']} ops -> "
              f"{by_ops:.4f} ms), {r['bound_ms'] / r['ms']:.1%} of bound")
    all_pairs = b * g * g * t
    print(f"[timing] cascade_filter rank compares: {out['cascade_filter']['pairs']}"
          f" on this data, {all_pairs} for all G^2*T pairs "
          f"({all_pairs / F32_OPS_PER_S * 1e3:.4f} ms at one op each)")
    return out


# -- 5. the slice -----------------------------------------------------------------

def check_responses(reqs, futures, params, cfg, ses) -> int:
    """Every served, undegraded response against the plain pipeline on the
    CPU for that request alone: scores to tolerance, survivors exactly
    where the request's decisions have margin, order a stable descending
    sort of the scores. Returns how many were checked."""
    cpu_params = {k: v.cpu() for k, v in params.items()}
    checked = 0
    for req, fut in zip(reqs, futures):
        r = fut.result()
        if r.status != "ok" or r.degraded:
            continue
        g = bucket_of(len(req.item_feats), ses.buckets)
        batch = alloc_batch(1, g, cfg.d_x, cfg.d_q)
        pack_into(batch, [req], g)
        t = {k: torch.tensor(v) for k, v in batch.items()}
        out = P.run_cascade(cpu_params, cfg, t["x"], t["q"], t["mask"],
                            t["m_q"], fused="none")
        n = len(r.scores)
        surv = out["survivors"][0, :n, -1] > 0
        want = torch.where(surv, out["scores"][0, :n], -torch.inf).numpy()
        np.testing.assert_allclose(r.scores, want, rtol=RTOL, atol=ATOL)
        try:
            assert_decision_margin(out["lp"], t["mask"], t["m_q"])
        except AssertionError:
            continue
        np.testing.assert_array_equal(r.survivors, surv.numpy())
        ranked = r.scores[r.order]
        kept = np.isfinite(ranked)
        assert kept[:kept.sum()].all() and (np.diff(ranked[kept]) <= 0).all()
        checked += 1
    return checked


def phase_slice(plan: str) -> tuple[dict, dict]:
    cfg = cloes.CASCADE
    log = generate_log(LogConfig(n_queries=800, seed=0))
    _, te = log.split(0.8)
    params = S.load_params(None, cfg, seed=0, device="cuda")
    ses = S.build_session(params, cfg, plan=plan, device="cuda")
    chunks = 0
    execute = ses.execute_chunk

    def counted(chunk):
        nonlocal chunks
        chunks += 1
        return execute(chunk)
    ses.execute_chunk = counted
    reqs = S.make_requests(te, DES_REQUESTS, seed=0)

    ops.reset_launch_counts()        # the main path starts here
    t0 = time.perf_counter()
    shapes = ses.warmup()
    warmup_s = time.perf_counter() - t0
    warm_launches = ops.launch_counts()
    shapes_after_warmup = S.compiled_count([ses])
    res = run_open_loop(ses, reqs, DES_QPS, deadline_ms=DES_DEADLINE_MS,
                        seed=0)
    sync()
    launches = ops.launch_counts()   # ... and ends here
    st = ses.stats_export()
    new_shapes = S.compiled_count([ses]) - shapes_after_warmup

    kernel = "cascade_filter" if plan == "filter" else "cascade_score_batched"
    serve_launches = launches[kernel] - warm_launches[kernel]
    assert res.unresolved == 0, f"{res.unresolved} futures unresolved"
    assert all(f.done() for f in res.futures)
    assert st["submitted"] == st["completed"] + st["shed"] + st["errors"], st
    assert st["faults"] == 0 and st["errors"] == 0, \
        f"plan {plan}: faults {st['faults']} errors {st['errors']}"
    assert new_shapes == 0, f"{new_shapes} shapes first seen after warmup"
    assert warm_launches[kernel] >= len(shapes), warm_launches
    assert serve_launches >= chunks > 0, (serve_launches, chunks)
    checked = check_responses(reqs, res.futures, params, cfg, ses)
    assert checked > 0
    print(f"[slice {plan}] warmed {len(shapes)} shapes in {warmup_s:.2f}s; "
          f"served {res.completed}/{res.n_requests} (shed {res.shed}, "
          f"errors {res.errors}, degraded {res.degraded}, deadline-missed "
          f"{res.deadline_missed}) in {chunks} chunks; "
          f"{res.achieved_qps:.1f} QPS achieved over {res.sim_s:.3f}s "
          f"simulated, {res.serve_s:.4f}s compute "
          f"({1e3 * res.serve_s / max(chunks, 1):.4f} ms/chunk)")
    print(f"[slice {plan}] latency p50 {res.pct(50):.3f} ms, p95 "
          f"{res.pct(95):.3f} ms, p99 {res.pct(99):.3f} ms; "
          f"recompiles after warmup: {new_shapes}; launches {launches} "
          f"(warmup {warm_launches}); {checked} responses match the plain "
          "pipeline on the CPU")
    return launches, res.summary()


def main() -> None:
    phase_device()
    phase_build()
    errs = phase_parity()
    timing = phase_timing()
    launches = {}
    for plan in ("filter", "score"):
        counts, _ = phase_slice(plan)
        kernel = ("cascade_filter" if plan == "filter"
                  else "cascade_score_batched")
        launches[kernel] = counts[kernel]
    rows = []
    for name, info in KERNEL_INFO.items():
        tm = timing[name]
        rows.append({"name": name, **info, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": tm["ms"],
                     "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                     "bound_by": tm["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
