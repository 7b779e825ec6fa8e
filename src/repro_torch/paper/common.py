"""What the paper suites share: the benchmark logs, the trained CLOES
fits, the CSV rows and claims they print, and their command line.

The port's copy of the reference's `benchmarks/common.py` (its speed
timer `time_call` belongs to the speed benches and is not here). Every
suite takes the (train, test) split and the device as arguments, so a
test runs it on a small log on the CPU."""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import baselines as B
from repro_torch.core import losses as L
from repro_torch.core import trainer as T
from repro_torch.data import LogConfig, SearchLog, generate_log
from repro_torch.launch.mesh import device_of

# "ci" is the reference's benchmark log (`benchmarks/common.bench_log`:
# ~39k instances); "paper" is the paper's offline dataset size (2M
# instances: 61,500 queries x 64 items give 1,998,780).
SCALES = {"ci": LogConfig(n_queries=1200, items_per_query=64, seed=42),
          "paper": LogConfig(n_queries=61500, items_per_query=64, seed=42)}

Split = tuple[SearchLog, SearchLog]
Claim = tuple[str, bool, str]


@functools.lru_cache(maxsize=2)
def bench_log(scale: str = "ci") -> SearchLog:
    """The offline benchmark dataset at `scale` (a SCALES key)."""
    return generate_log(SCALES[scale])


@functools.lru_cache(maxsize=2)
def bench_split(scale: str = "ci") -> Split:
    """(train, test) of `bench_log(scale)`, split 80/20 with seed 0."""
    return bench_log(scale).split(0.8, seed=0)


def log_tensors(log: SearchLog, device, idx=None) -> tuple[torch.Tensor, ...]:
    """(x, q, mask, m_q) of the log (or of its groups idx) as float32
    tensors on `device`."""
    def t(a):
        a = a if idx is None else a[idx]
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)
    return t(log.x), t(log.q), t(log.mask), t(log.m_q)


# (id of the split, device, fit arguments) -> (split, fit). The split is
# kept in the value so its id is not reused while the entry lives.
_FITS: dict[tuple, tuple] = {}


def trained_cloes(split: Split, device, beta: float = 5.0,
                  delta: float = 1.0, eps_latency: float = 0.05,
                  eps_purchase: float = 1.0, mu_price: float = 1.0,
                  latency_scale: float | None = None):
    """(params, cfg, lcfg) of CLOES fitted on the split's train half on
    `device` — the reference's `trained_cloes` arguments and TrainConfig
    (6 epochs at lr 0.01, seed 0). Cached per split, device and
    arguments, so the suites share a fit."""
    device = torch.device(device)
    args = (beta, delta, eps_latency, eps_purchase, mu_price, latency_scale)
    key = (id(split), device, args)
    if key not in _FITS:
        kw = {} if latency_scale is None else {"latency_scale": latency_scale}
        lcfg = L.LossConfig(beta=beta, delta=delta, eps_latency=eps_latency,
                            eps_purchase=eps_purchase, mu_price=mu_price,
                            **kw)
        params, cfg = B.fit_cloes(
            split[0], lcfg=lcfg,
            tcfg=T.TrainConfig(loss="l3", epochs=6, lr=0.01), device=device)
        _FITS[key] = (split, (params, cfg, lcfg))
    return _FITS[key][1]


def clear_fits() -> None:
    """Drop every cached fit."""
    _FITS.clear()


def emit(name: str, us_per_call: float, derived: str) -> None:
    """One `name,us_per_call,derived` CSV row, as the reference prints."""
    print(f"{name},{us_per_call:.1f},{derived}")


@dataclasses.dataclass
class SuiteResult:
    """A suite's rows (its own structure), its claims and its seconds."""
    name: str
    rows: object
    claims: list[Claim]
    seconds: float

    @property
    def failed(self) -> list[str]:
        return [name for name, held, _ in self.claims if not held]


def emit_claims(res: SuiteResult) -> None:
    """One CSV row with every claim of the suite, held or not."""
    held = sum(1 for _, h, _ in res.claims if h)
    body = ";".join(f"{name}={'held' if h else 'NOT_HELD'}({detail})"
                    for name, h, detail in res.claims)
    emit(f"claims/{res.name}", res.seconds * 1e6,
         f"held={held}/{len(res.claims)};{body}")


def run_suite(name: str, fn: Callable[[Split, torch.device], tuple],
              split: Split, device) -> SuiteResult:
    """Run one suite's `fn(split, device) -> (rows, claims)` and time it."""
    t0 = time.perf_counter()
    rows, claims = fn(split, device_of(device))
    return SuiteResult(name, rows, claims, time.perf_counter() - t0)


def parse_args(prog: str, argv: list[str] | None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--scale", choices=sorted(SCALES), default="ci",
                    help="ci: the reference's 1,200 x 64 log; paper: "
                         "61,500 x 64 (1,998,780 instances)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def suite_main(name: str, fn, argv: list[str] | None = None) -> int:
    """The command line of one suite: its rows and claims; 1 if a claim
    failed, else 0."""
    from repro_torch.paper import MODULES
    args = parse_args(f"python -m repro_torch.paper.{MODULES[name]}", argv)
    device = device_of(args.device)
    res = run_suite(name, fn, bench_split(args.scale), device)
    emit_claims(res)
    return 1 if res.failed else 0
