"""Paper Table 3: offline AUC and CPU cost of six algorithms.

Single-stage (all features), single-stage (simple features), the 2-stage
heuristic, the soft cascade (the product model trained with L1),
CLOES(beta=1) and CLOES(beta=10), each fitted for 6 epochs at lr 0.01 and
evaluated on train and test. The cost column is the ratio to the
single-stage-all baseline, as in the paper. The port's counterpart of
`benchmarks/table3_offline.py`.

    python -m repro_torch.paper.table3_offline [--scale ci|paper] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import sys
import time

from repro_torch.core import baselines as B
from repro_torch.core import losses as L
from repro_torch.core import trainer as T
from repro_torch.paper import common

# (train AUC, test AUC, cost ratio) as the paper's Table 3 prints them
PAPER = {"single_stage_all": (0.88, 0.87, 1.0),
         "single_stage_simple": (0.73, 0.72, 0.06),
         "two_stage_6000": (0.78, 0.76, 0.30),
         "soft_cascade_L1": None,
         "CLOES_beta1": (0.81, 0.80, 0.29),
         "CLOES_beta10": (0.80, 0.77, 0.18)}


def _tcfg(loss: str) -> T.TrainConfig:
    return T.TrainConfig(loss=loss, epochs=6, lr=0.01)


def rows(split: common.Split, device) -> list[dict]:
    """The six algorithms' rows: {"algo", "train_auc", "test_auc", "cost",
    "paper", "fit_s", "eval_s"}."""
    tr, te = split
    out = []
    clock = [time.perf_counter()]

    def lap() -> float:
        now = time.perf_counter()
        dt, clock[0] = now - clock[0], now
        return dt

    def add(algo, fit_s, r_tr, r, cost):
        out.append({"algo": algo, "train_auc": r_tr["auc"],
                    "test_auc": r["auc"], "cost": cost,
                    "paper": PAPER[algo], "fit_s": fit_s, "eval_s": lap()})

    cfg = B.single_stage_all_features()
    p = T.fit(tr, cfg, L.LossConfig(), _tcfg("l1"), device=device)
    fit_s = lap()
    r = T.evaluate(p, cfg, te)
    base = r["expected_cost_per_item"]
    add("single_stage_all", fit_s, T.evaluate(p, cfg, tr), r, 1.0)

    cfg = B.single_stage_simple_features()
    p = T.fit(tr, cfg, L.LossConfig(), _tcfg("l1"), device=device)
    fit_s = lap()
    r = T.evaluate(p, cfg, te)
    add("single_stage_simple", fit_s, T.evaluate(p, cfg, tr), r,
        r["expected_cost_per_item"] / base)

    ts = B.fit_two_stage(tr, tcfg=_tcfg("l1"), device=device)
    fit_s = lap()
    r = B.eval_two_stage(ts, te)
    add("two_stage_6000", fit_s, B.eval_two_stage(ts, tr), r,
        r["expected_cost_per_item"] / base)

    p, cfg = B.fit_soft_cascade(tr, tcfg=_tcfg("l1"), device=device)
    fit_s = lap()
    r = T.evaluate(p, cfg, te)
    add("soft_cascade_L1", fit_s, T.evaluate(p, cfg, tr), r,
        r["expected_cost_per_item"] / base)

    for beta in (1.0, 10.0):
        p, cfg = B.fit_cloes(tr, lcfg=L.LossConfig(beta=beta),
                             tcfg=_tcfg("l3"), device=device)
        fit_s = lap()
        r = T.evaluate(p, cfg, te)
        add(f"CLOES_beta{int(beta)}", fit_s, T.evaluate(p, cfg, tr), r,
            r["expected_cost_per_item"] / base)
    return out


def claims(rows_: list[dict]) -> list[common.Claim]:
    """Table 3's qualitative claims, as the reference asserts them."""
    by = {r["algo"]: r for r in rows_}
    best = max(r["test_auc"] for r in rows_)
    cheapest = min(r["cost"] for r in rows_)
    c1, two, c10 = by["CLOES_beta1"], by["two_stage_6000"], by["CLOES_beta10"]
    return [
        ("single_stage_all_best_test_auc",
         by["single_stage_all"]["test_auc"] == best,
         f"{by['single_stage_all']['test_auc']:.4f} vs best {best:.4f}"),
        ("single_stage_simple_cheapest",
         by["single_stage_simple"]["cost"] == cheapest,
         f"{by['single_stage_simple']['cost']:.4f} vs least {cheapest:.4f}"),
        ("cloes_beta1_dominates_two_stage",
         c1["test_auc"] > two["test_auc"] and c1["cost"] <= two["cost"] * 1.05,
         f"auc {c1['test_auc']:.4f} vs {two['test_auc']:.4f}, cost "
         f"{c1['cost']:.4f} vs {two['cost']:.4f}"),
        ("cloes_beta10_cheaper_than_beta1", c10["cost"] < c1["cost"],
         f"{c10['cost']:.4f} vs {c1['cost']:.4f}"),
    ]


def emit_rows(rows_: list[dict]) -> None:
    for row in rows_:
        paper = row["paper"]
        ptxt = (f"paper_train={paper[0]}_test={paper[1]}_cost={paper[2]}"
                if paper else "paper_na")
        common.emit(f"table3/{row['algo']}",
                    (row["fit_s"] + row["eval_s"]) * 1e6,
                    f"train_auc={row['train_auc']:.3f};"
                    f"test_auc={row['test_auc']:.3f};"
                    f"cost_ratio={row['cost']:.3f};{ptxt}")


def run(split: common.Split, device) -> tuple[list[dict], list[common.Claim]]:
    """Fit, evaluate and print the six rows; (rows, claims)."""
    out = rows(split, device)
    emit_rows(out)
    return out, claims(out)


if __name__ == "__main__":
    sys.exit(common.suite_main("table3", run))
