"""Run the five paper suites: ``python -m repro_torch.paper [--scale
ci|paper] [--device cuda|cpu]``.

Prints the ``name,us_per_call,derived`` CSV rows of every suite, one
``claims/<suite>`` row each, and one ``suite/<suite>`` status row; exits
nonzero when any claim failed. The port's counterpart of the reference's
`benchmarks/run.py` for the paper's tables and figures (its speed benches
are not ported). An exception in a suite is not caught: it ends the run.
"""

from __future__ import annotations

import importlib
import sys

from repro_torch.launch.mesh import device_of
from repro_torch.paper import MODULES, common


def main(argv: list[str] | None = None) -> int:
    args = common.parse_args("python -m repro_torch.paper", argv)
    device = device_of(args.device)
    split = common.bench_split(args.scale)
    print("name,us_per_call,derived")
    failed = []
    for name, module in MODULES.items():
        run = importlib.import_module(f"repro_torch.paper.{module}").run
        res = common.run_suite(name, run, split, device)
        common.emit_claims(res)
        status = "ok" if not res.failed else "CLAIMS_FAILED:" + "|".join(
            res.failed)
        common.emit(f"suite/{name}", res.seconds * 1e6, f"status={status}")
        failed += [f"{name}/{c}" for c in res.failed]
    if failed:
        print(f"paper claims not held: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
