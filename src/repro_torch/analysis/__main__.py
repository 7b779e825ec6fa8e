"""CLI: ``PYTHONPATH=src python -m repro_torch.analysis [paths...]``.

No paths: walk ``src/repro_torch``, the port's tests and
``chip_smoke.py`` (minus the fixture corpus) and write
``ANALYSIS_torch_report.json`` at the repo root.  Explicit paths: lint
just those (how the self-tests aim one bad fixture at the gate).  Exit 0
when clean, 1 when any rule fires.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from repro_torch.analysis import core


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="cascade-lint: the port's serving-invariant static "
                    "analysis")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs to lint (default: src/repro_torch, "
                         "tests/test_torch_*.py, tests/torch_parity.py, "
                         "chip_smoke.py)")
    ap.add_argument("--report", type=Path,
                    default=core.REPO_ROOT / "ANALYSIS_torch_report.json",
                    help="where to write the JSON report")
    ap.add_argument("--no-report", action="store_true",
                    help="skip writing the report file")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    targets = args.paths or core.default_targets()
    files = core.collect_files(targets)
    findings = core.run(files)
    dt = time.perf_counter() - t0

    if not args.no_report:
        core.write_report(findings, files, args.report)
    for f in findings:
        print(f)
    status = "FAIL" if findings else "ok"
    print(f"[cascade-lint] {status}: {len(findings)} finding(s) over "
          f"{len(files)} files in {dt:.2f}s "
          f"({len(core.all_rules())} rules)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
