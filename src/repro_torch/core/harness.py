"""Timing and characterization primitives — CUDA events, as the paper uses.

Counterpart of ``repro/core/harness.py``, which imitates CUDA events with a
host clock and ``block_until_ready``. Here the events are real. Two timing
modes:

- **sync mode** (``time_fn`` with ``window=1``, the default): after the
  warm-up, each measured call is bracketed by a pair of
  ``torch.cuda.Event``s on the current stream and the host synchronizes on
  the second one. Each sample is the device time from the first event to
  the second, which includes any gap the device spent waiting for the host
  to enqueue the call's kernels (``us_per_call``).
- **windowed mode** (``window=K``): one event pair brackets K back-to-back
  calls and the sample is the elapsed time over K. The host enqueues call
  *i+1* while the device runs call *i*, so launch gaps hide behind device
  work and the quotient approaches the device's own time per call
  (``us_per_call_windowed``); ``sync − windowed`` is the per-call overhead
  sync mode folds into its number.

On the CPU, which a caller must ask for explicitly, both modes time with
``time.perf_counter`` around calls that return finished tensors.

Both modes assume the inputs already sit on the device: ``commit_args``
moves them there once, before any loop, so no timed call pays a host copy.
Host-transfer rows (``no_jit``) are the exception: the copy is what they
time.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.metrics import RooflineTerms, peaks_for, roofline_terms
from repro_torch.core.registry import Workload

__all__ = [
    "TimingResult",
    "CompiledInfo",
    "commit_args",
    "time_fn",
    "timing_from_stats",
    "characterize",
    "empty_compiled_info",
    "row_dtype",
]


@dataclasses.dataclass(frozen=True)
class TimingResult:
    name: str
    us_per_call: float
    us_stdev: float
    iters: int
    achieved_gflops: float  # from the workload's analytic FLOP count
    achieved_gbps: float  # from the workload's analytic byte count
    # Windowed-mode companion numbers (None when only sync mode ran): the
    # per-call time with K calls per event pair, K, and the derived per-call
    # overhead (sync − windowed, clamped at 0).
    us_per_call_windowed: float | None = None
    timing_window: int | None = None
    timer_dispatch_us: float | None = None


@dataclasses.dataclass(frozen=True)
class CompiledInfo:
    """Static characterization of one pass: its analytic roofline against
    the peaks of the card it ran on (``peaks``)."""

    name: str
    roofline: RooflineTerms
    peaks: str


def commit_args(args: Sequence[Any], device: str | torch.device) -> tuple:
    """Move host-side arguments to ``device``, once, before any timing loop.

    Tensors already on ``device`` pass through untouched (``.to`` returns
    the same object); other tensors and numpy arrays are copied there.
    Python scalars and anything else that is not an array pass through
    unchanged: torch ops take them as they are. On a CUDA device the copies
    are synchronized before returning, so no timed call waits on them.
    """
    device = torch.device(device)

    def commit(leaf: Any) -> Any:
        if isinstance(leaf, torch.Tensor):
            return leaf.to(device)
        if isinstance(leaf, np.ndarray):
            return torch.from_numpy(leaf).to(device)
        return leaf

    out = tuple(commit(a) for a in args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def time_fn(
    fn: Callable[..., Any],
    args: Sequence[Any],
    *,
    iters: int = 10,
    warmup: int = 3,
    window: int = 1,
    device: str | torch.device = "cuda",
) -> tuple[float, float]:
    """Return (mean_us, stdev_us) per call of ``fn(*args)``.

    ``window=1`` is sync mode (one event pair and one synchronization per
    call); ``window=K`` times each of ``iters`` samples over K back-to-back
    calls. CUDA devices time with events, the CPU with ``perf_counter``.
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    device = torch.device(device)
    cuda = device.type == "cuda"
    for _ in range(warmup):
        fn(*args)
    if cuda:
        torch.cuda.synchronize(device)
    samples = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(window):
                fn(*args)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) * 1e3 / window)
        else:
            t0 = time.perf_counter()
            for _ in range(window):
                fn(*args)
            samples.append((time.perf_counter() - t0) * 1e6 / window)
    mean = statistics.fmean(samples)
    stdev = statistics.stdev(samples) if len(samples) > 1 else 0.0
    return mean, stdev


def timing_from_stats(
    workload: Workload,
    *,
    mean_us: float,
    stdev_us: float,
    iters: int,
    backward: bool = False,
    windowed_us: float | None = None,
    window: int | None = None,
) -> TimingResult:
    """Fold measured time with the workload's analytic FLOP/byte counts.

    ``windowed_us`` / ``window`` attach the windowed-mode companion number
    when both modes ran; the derived overhead is computed here so every
    consumer sees the same clamping convention.
    """
    flops = workload.flops_bwd if backward else workload.flops
    sec = mean_us / 1e6
    return TimingResult(
        name=workload.name + (".bwd" if backward else ""),
        us_per_call=mean_us,
        us_stdev=stdev_us,
        iters=iters,
        achieved_gflops=(flops / sec / 1e9) if (flops and sec > 0) else 0.0,
        achieved_gbps=(workload.bytes_moved / sec / 1e9)
        if (workload.bytes_moved and sec > 0)
        else 0.0,
        us_per_call_windowed=windowed_us,
        timing_window=window if windowed_us is not None else None,
        timer_dispatch_us=(
            max(mean_us - windowed_us, 0.0) if windowed_us is not None else None
        ),
    )


def row_dtype(args: Sequence[Any]) -> torch.dtype | None:
    """The dtype a row's peak is taken for: its first floating input's."""
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.dtype
    return None


def characterize(
    workload: Workload,
    args: Sequence[Any],
    *,
    backward: bool = False,
    device_name: str | None = None,
) -> CompiledInfo:
    """The pass's analytic roofline on the card named ``device_name``."""
    hw = peaks_for(device_name)
    flops = workload.flops_bwd if backward else workload.flops
    return CompiledInfo(
        name=workload.name + (".bwd" if backward else ""),
        roofline=roofline_terms(
            flops, workload.bytes_moved, dtype=row_dtype(args), hw=hw
        ),
        peaks=hw.name,
    )


def empty_compiled_info(name: str) -> CompiledInfo:
    """No roofline, for a workload with no device program (``no_jit``
    meta): its bytes cross the host bus, which no HBM rate bounds."""
    return CompiledInfo(name=name, roofline=roofline_terms(0.0, 0.0), peaks="none")
