"""Benchmark runner of the port: one section per paper table or figure.

Counterpart of ``benchmarks/run.py``, with its CLI: ``--sections`` (checked
before anything is imported; exit 2 and the valid list on an unknown one),
``--preset``, CSV ``name,us_per_call,derived`` on stdout, a section that
raises printed as a ``<section>.FAILED`` row, and exit 1 when any row
failed. The port has the paper's four §V-B feature studies so far:

  feat_hyperq              — HyperQ: Pathfinder instances through a sync
                             loop, a windowed loop, one batched call and
                             one CUDA stream each
  feat_unified_memory      — Unified Memory: BFS on managed memory paged
                             on demand, prefetched, and device-resident
  feat_coop_groups         — Cooperative Groups: SRAD's cooperative fused
                             step against its two split phases
  feat_dynamic_parallelism — Dynamic Parallelism: Mandelbrot flat against
                             Mariani-Silver with device-side launch

The studies take their own sizes (the reference's); ``--preset`` is for
the report sections still to come. ``--device`` is ``cuda`` unless the
caller asks for the CPU, where the plain versions run; without a CUDA card
a ``cuda`` run exits 2 before measuring anything. ``CUDA_DEVICE_MAX_CONNECTIONS``
(HyperQ's hardware queues, 8 unless set before the process starts) is
recorded in every HyperQ row.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

SECTION_NAMES = (
    "feat_hyperq",
    "feat_unified_memory",
    "feat_coop_groups",
    "feat_dynamic_parallelism",
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sections", nargs="*", default=None,
                    help=f"subset of sections to run; valid: {', '.join(SECTION_NAMES)}")
    ap.add_argument("--preset", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    selected = args.sections or list(SECTION_NAMES)
    unknown = [s for s in selected if s not in SECTION_NAMES]
    if unknown:
        print(f"unknown section(s): {', '.join(unknown)}", file=sys.stderr)
        print(f"valid sections: {', '.join(SECTION_NAMES)}", file=sys.stderr)
        return 2

    # Imported after validation so a bad --sections fails fast, before torch.
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (ask for --device cpu "
              "to run the plain versions)", file=sys.stderr)
        return 2

    from repro_torch.benchmarks import (
        feat_coop_groups,
        feat_dynamic_parallelism,
        feat_hyperq,
        feat_unified_memory,
    )
    from repro_torch.benchmarks.common import ERROR_PREFIX

    modules = {
        "feat_hyperq": feat_hyperq,
        "feat_unified_memory": feat_unified_memory,
        "feat_coop_groups": feat_coop_groups,
        "feat_dynamic_parallelism": feat_dynamic_parallelism,
    }
    # SECTION_NAMES exists so --sections validates before the imports above;
    # keep the two in sync.
    assert set(modules) == set(SECTION_NAMES), "update SECTION_NAMES"

    print("name,us_per_call,derived")
    failures = 0
    for name in selected:
        t0 = time.time()
        try:
            for n, us, d in modules[name].rows(device=args.device):
                if d.startswith(ERROR_PREFIX):
                    failures += 1
                    print(f"# ERROR {n}: {d}", file=sys.stderr, flush=True)
                print(f"{n},{us:.2f},{d}", flush=True)
        except Exception:  # noqa: BLE001  (a failed section is a row, the others run)
            failures += 1
            traceback.print_exc()
            print(f"{name}.FAILED,0.00,error", flush=True)
        print(f"# section {name} done in {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
