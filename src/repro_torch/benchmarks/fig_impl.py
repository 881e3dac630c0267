"""Implementation-axis figure: torch against the hand-written kernels, per
workload.

Counterpart of ``benchmarks/fig_impl.py``. Every kernel-backed benchmark
runs twice through the engine: under ``impl=torch`` (the plain PyTorch
path: cuBLAS, cuDNN, ATen) and under ``impl=kernel`` (the hand-written
kernel from ``src/repro_torch/kernels/``, its tile swept by the tune stage
when ``tune`` is on, as it is by default), and the figure reports both
times and the kernel row's speedup over its torch twin.

Rows are named ``fig_impl.<benchmark>.<requested impl>``; the derived
field carries the *effective* impl (a workload with no kernel falls back to
torch and says so), the interpret flag (kernel rows on the CPU ran the
plain versions: a check of the path, not a kernel number), the tuned block
parameters, and ``speedup_vs_torch``.

As a section (``python -m repro_torch.benchmarks.run --sections
fig_impl``) it emits the standard CSV rows; as a script it prints a
per-benchmark pivot table:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig_impl --preset 4
"""

from __future__ import annotations

import sys

from repro_torch.benchmarks.common import ERROR_PREFIX, Row, parse_derived
from repro_torch.core.suite import run_suite

# Kernel-backed cross-section: GEMM, row reduce, channel window, pooling,
# prefix scan: one workload per kernel family.
DEFAULT_NAMES = (
    "gemm_f32_nn",
    "softmax",
    "lrn",
    "pooling",
    "where",
)
IMPLS = ("torch", "kernel")


class ImplFigureError(ValueError):
    """A sweep that cannot produce the figure (empty selection). main()
    prints the one-line message and exits 2 instead of a traceback."""


def _derive(r, torch_us: dict[str, float]) -> str:
    parts = [f"impl={r.impl}"]
    if r.impl_interpret is not None:
        parts.append(f"interpret={int(r.impl_interpret)}")
    if r.impl_fallback:
        parts.append(f"fallback={r.impl_fallback}")
    if r.tuned_params:
        tuned = "/".join(f"{k}={v}" for k, v in sorted(r.tuned_params.items()))
        parts.append(f"tuned={tuned}")
    if r.tune_trials is not None:
        parts.append(f"tune_trials={r.tune_trials}")
    base = torch_us.get(r.name)
    if r.impl == "kernel" and base:
        parts.append(f"speedup_vs_torch={base / r.us_per_call:.3f}")
    return ";".join(parts)


def rows(
    preset: int = 0,
    names=DEFAULT_NAMES,
    tune: bool = True,
    iters: int = 3,
    *,
    device: str = "cuda",
) -> list[Row]:
    if not names:
        raise ImplFigureError("fig_impl: empty --names selection")
    by_impl = {
        impl: run_suite(
            names=list(names),
            preset=preset,
            iters=iters,
            warmup=1,
            include_backward=False,
            impl=impl,
            tune=tune and impl == "kernel",
            device=device,
            verbose=False,
        )
        for impl in IMPLS
    }
    torch_us = {r.name: r.us_per_call for r in by_impl["torch"] if r.status == "ok"}
    out: list[Row] = []
    for impl in IMPLS:
        for r in by_impl[impl]:
            name = f"fig_impl.{r.name}.{impl}"
            if r.status != "ok":
                out.append((name, 0.0, f"{ERROR_PREFIX}{r.error};{r.derived}"))
            else:
                out.append((name, r.us_per_call, _derive(r, torch_us)))
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", type=int, default=0)
    ap.add_argument("--names", nargs="*", default=list(DEFAULT_NAMES))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--no-tune", action="store_true",
                    help="time kernel rows at their default tiles")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    try:
        out = rows(
            preset=args.preset, names=tuple(args.names),
            tune=not args.no_tune, iters=args.iters, device=args.device,
        )
    except ImplFigureError as e:
        print(str(e), file=sys.stderr)
        return 2
    except ValueError as e:  # bad selection, no card: configuration, not a crash
        print(f"fig_impl: {e}", file=sys.stderr)
        return 2
    # Pivot into one line per benchmark: torch us, kernel us, speedup, tuning.
    table: dict[str, dict[str, tuple[float, dict[str, str]]]] = {}
    errors = 0
    for name, us, derived in out:
        if derived.startswith(ERROR_PREFIX):
            errors += 1
            print(f"# {name}: {derived}", file=sys.stderr)
            continue
        bench, _, impl = name.removeprefix("fig_impl.").rpartition(".")
        table.setdefault(bench, {})[impl] = (us, parse_derived(derived))
    if not table:
        print(
            f"fig_impl: zero ok records in the sweep "
            f"({errors} error rows, see above) — nothing to tabulate",
            file=sys.stderr,
        )
        return 1
    print(f"{'benchmark':<28}{'torch us':>12}{'kernel us':>12}"
          f"{'speedup':>9}  tuned")
    for bench, per_impl in table.items():
        torch_us, _ = per_impl.get("torch", (0.0, {}))
        kernel_us, fields = per_impl.get("kernel", (0.0, {}))
        speedup = fields.get("speedup_vs_torch", "-")
        note = fields.get("tuned", "")
        if fields.get("fallback"):
            note = f"fallback={fields['fallback']}"
        if fields.get("interpret") == "1":
            note = (note + " " if note else "") + "[interpret]"
        print(f"{bench:<28}{torch_us:>12.1f}{kernel_us:>12.1f}{speedup:>9}  {note}")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
