"""Example: trace one (arch x shape) rank's step on the 2-pod production
mesh (512 chips: pod 2, data 16, model 16) and print its record without
`memory`: its FLOPs, bytes, collectives, classes of ranks and roofline
terms at H100 peaks and links (`launch/dryrun.py` `pod_record`). Traces
on `meta` tensors on the CPU; nothing is allocated.

    PYTHONPATH=src python -m repro_torch.examples.multi_pod_dryrun \
        --arch gemma3-27b --shape long_500k [--single-pod] [--variant auto]
"""

from __future__ import annotations

import argparse
import json

from repro_torch import configs as CFG
from repro_torch.configs import shapes as SH
from repro_torch.launch import dryrun


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-27b", choices=CFG.all_archs())
    ap.add_argument("--shape", default="long_500k", choices=list(SH.SHAPES))
    ap.add_argument("--single-pod", action="store_true",
                    help="the 256-chip mesh (data 16, model 16)")
    ap.add_argument("--variant", default="auto",
                    choices=dryrun.POD_VARIANTS)
    args = ap.parse_args(argv)
    variant = (dryrun.pod_variant(CFG.get(args.arch), args.shape)
               if args.variant == "auto" else args.variant)
    rec = dryrun.pod_record(args.arch, args.shape,
                            multi_pod=not args.single_pod, variant=variant)
    print(json.dumps({k: v for k, v in rec.items() if k != "memory"},
                     indent=2, default=str))


if __name__ == "__main__":
    main()
