"""Reproduce the paper's §V-B modern-feature studies in one command.

Counterpart of ``examples/feature_analysis.py``. Runs all four feature
studies (HyperQ, Unified Memory, Cooperative Groups, Dynamic Parallelism),
each on the CUDA feature it names (``repro_torch.benchmarks.feat_*``), at
the reference's sizes, and prints the speedup curves the paper plots.

Usage: PYTHONPATH=src python -m repro_torch.examples.feature_analysis [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.benchmarks import (
    feat_coop_groups,
    feat_dynamic_parallelism,
    feat_hyperq,
    feat_unified_memory,
)
from repro_torch.launch.serve import resolve_device

SECTIONS = [
    ("HyperQ → batched occupancy (Pathfinder)", feat_hyperq.rows),
    ("Unified Memory → staging vs prefetch (BFS)", feat_unified_memory.rows),
    ("Cooperative Groups → fused stencil (SRAD)", feat_coop_groups.rows),
    ("Dynamic Parallelism → adaptive tiles (Mandelbrot)", feat_dynamic_parallelism.rows),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"feature_analysis: {e}", file=sys.stderr)
        return 2
    for title, fn in SECTIONS:
        print(f"\n=== {title} ===")
        for name, us, derived in fn(device=args.device):
            print(f"  {name:<28} {us:>12.1f} us   {derived}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
