"""Benchmark runner of the port: one section per paper table or figure.

Counterpart of ``benchmarks/run.py``, with its CLI: ``--sections`` (checked
before anything is imported; exit 2 and the valid list on an unknown one),
``--preset``, CSV ``name,us_per_call,derived`` on stdout, a section that
raises printed as a ``<section>.FAILED`` row, each section's seconds on
stderr, and exit 1 when any row failed. Sections:

  table1                   — the suite listing (Table I)
  fig12                    — levels 0-1 utilization (Figs. 1-2)
  fig3 / fig4              — DNN forward / backward utilization
  fig5                     — level-2 utilization (Fig. 5)
  fig_impl                 — torch against the hand-written kernels, the
                             kernels' tiles tuned
  table2                   — per-layer kernel classification (Table II),
                             at ``max(--preset, 1)``
  feat_hyperq              — HyperQ: Pathfinder instances through a sync
                             loop, a windowed loop, one batched call and
                             one CUDA stream each
  feat_unified_memory      — Unified Memory: BFS on managed memory paged
                             on demand, prefetched, and device-resident
  feat_coop_groups         — Cooperative Groups: SRAD's cooperative fused
                             step against its two split phases
  feat_dynamic_parallelism — Dynamic Parallelism: Mandelbrot flat against
                             Mariani-Silver with device-side launch
  roofline                 — roofline rows of the suite report at
                             ``artifacts/suite_report.json``, if there is one
  fig_concurrency          — dispatch lanes under the single and the
                             threaded client, and a co-located pair
  fig_batching             — loop, lanes and the dynamic batcher replaying
                             one mixed-shape trace

The suite-backed sections (fig12, fig3, fig4, fig5, fig_impl,
fig_concurrency, fig_batching) run through ``run_suite`` at ``--preset``
with per-benchmark fault isolation, ``--impl`` naming the implementation of
the two serving sections (torch, the reference's default, or kernel); the
feature studies take their own sizes (the reference's). The reference's
``fig_scaling``, ``fig_dist`` and ``fig_trace`` wait for device sweeps,
distributed load generation and tracing (ROADMAP queue 1, items 12 and
15), and its dry-run roofline cells for item 16.5.

``--device`` is ``cuda`` unless the caller asks for the CPU, where the
plain versions run; without a CUDA card a ``cuda`` run exits 2 before
measuring anything. ``CUDA_DEVICE_MAX_CONNECTIONS`` (HyperQ's hardware
queues, 8 unless set before the process starts) is recorded in every
HyperQ row.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

SECTION_NAMES = (
    "table1",
    "fig12",
    "fig3",
    "fig4",
    "fig5",
    "fig_impl",
    "table2",
    "feat_hyperq",
    "feat_unified_memory",
    "feat_coop_groups",
    "feat_dynamic_parallelism",
    "roofline",
    "fig_concurrency",
    "fig_batching",
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sections", nargs="*", default=None,
                    help=f"subset of sections to run; valid: {', '.join(SECTION_NAMES)}")
    ap.add_argument("--preset", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--impl", choices=("torch", "kernel"), default="torch",
                    help="implementation the serving sections time (default torch, "
                         "the reference's default)")
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
        fig3_dnn_forward,
        fig_batching,
        fig_concurrency,
        fig4_dnn_backward,
        fig5_suite_utilization,
        fig12_legacy_utilization,
        fig_impl,
        roofline_table,
        table1_suite,
        table2_dnn_kernels,
    )
    from repro_torch.benchmarks.common import ERROR_PREFIX

    preset, device, impl = args.preset, args.device, args.impl
    sections = {
        "table1": table1_suite.rows,
        "fig12": lambda: fig12_legacy_utilization.rows(preset=preset, device=device),
        "fig3": lambda: fig3_dnn_forward.rows(preset=preset, device=device),
        "fig4": lambda: fig4_dnn_backward.rows(preset=preset, device=device),
        "fig5": lambda: fig5_suite_utilization.rows(preset=preset, device=device),
        "fig_impl": lambda: fig_impl.rows(preset=preset, device=device),
        "table2": lambda: table2_dnn_kernels.rows(preset=max(preset, 1), device=device),
        "feat_hyperq": lambda: feat_hyperq.rows(device=device),
        "feat_unified_memory": lambda: feat_unified_memory.rows(device=device),
        "feat_coop_groups": lambda: feat_coop_groups.rows(device=device),
        "feat_dynamic_parallelism": lambda: feat_dynamic_parallelism.rows(device=device),
        "roofline": roofline_table.rows_from_latest_report,
        "fig_concurrency": lambda: fig_concurrency.rows(preset=preset, impl=impl, device=device),
        "fig_batching": lambda: fig_batching.rows(preset=preset, impl=impl, device=device),
    }
    # SECTION_NAMES exists so --sections validates before the imports above;
    # keep the two in sync.
    assert set(sections) == set(SECTION_NAMES), "update SECTION_NAMES"

    print("name,us_per_call,derived")
    failures = 0
    for name in selected:
        t0 = time.time()
        try:
            for n, us, d in sections[name]():
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
