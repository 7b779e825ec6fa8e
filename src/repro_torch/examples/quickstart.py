"""Quickstart: train the CLOES cascade on the synthetic e-commerce log and
reproduce the Table-3 trade-off.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port's counterpart of `examples/quickstart.py`.
"""

from __future__ import annotations

import argparse

from repro_torch.core import baselines as B
from repro_torch.core import losses as L
from repro_torch.core import trainer as T
from repro_torch.data import LogConfig, generate_log
from repro_torch.launch.mesh import device_of


def main(argv: list[str] | None = None) -> dict[str, dict[str, float]]:
    """Prints the rows and returns them: {name: {"auc", "cost"[,
    "p95_latency"]}}."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--queries", type=int, default=600)
    ap.add_argument("--epochs", type=int, default=5)
    args = ap.parse_args(argv)
    device = device_of(args.device)

    print("== CLOES quickstart ==")
    log = generate_log(LogConfig(n_queries=args.queries, seed=0))
    tr, te = log.split(0.8)
    print(f"log: {tr.n_instances} train instances, "
          f"pos rate {(tr.y * tr.mask).sum() / tr.n_instances:.3f}")

    cfg = B.single_stage_all_features()
    p = T.fit(tr, cfg, L.LossConfig(),
              T.TrainConfig(loss="l1", epochs=args.epochs, lr=0.01),
              device=device)
    r_all = T.evaluate(p, cfg, te)
    base = r_all["expected_cost_per_item"]
    rows = {"single_all": {"auc": r_all["auc"], "cost": 1.0}}
    print(f"single-stage(all):   AUC {r_all['auc']:.3f}  cost 1.00")

    for beta in (1.0, 10.0):
        params, ccfg = B.fit_cloes(
            tr, lcfg=L.LossConfig(beta=beta),
            tcfg=T.TrainConfig(loss="l3", epochs=args.epochs, lr=0.01),
            device=device)
        r = T.evaluate(params, ccfg, te, L.LossConfig(beta=beta))
        rows[f"cloes_beta{beta:g}"] = {
            "auc": r["auc"], "cost": r["expected_cost_per_item"] / base,
            "p95_latency": r["p95_expected_latency"]}
        print(f"CLOES(beta={beta:>4.1f}):    AUC {r['auc']:.3f}  "
              f"cost {r['expected_cost_per_item'] / base:.3f}  "
              f"latency p95 {r['p95_expected_latency']:.0f}ms")
    print("paper Table 3: single-all AUC .87 cost 1; "
          "CLOES(b=1) .80/.29; CLOES(b=10) .77/.18")
    return rows


if __name__ == "__main__":
    main()
