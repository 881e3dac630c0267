"""Roofline characterization against the H100's published peaks.

Counterpart of ``repro/core/metrics.py``. The paper characterizes every
benchmark with per-functional-unit utilization on a 0–10 scale (Figs. 1, 2,
5) and classifies kernels compute- vs memory-bound (§V-A). PyTorch has no
compiled artifact to ask for exact counts, so the roofline here comes from
the Workload's analytic ``flops`` and ``bytes_moved``:

    compute_s = flops       / peak FLOP/s of the row's dtype
    memory_s  = bytes_moved / HBM bytes/s

The dominant term is the bound; ``compute_s / max(terms)`` is the roofline
fraction, and ``utilization_scale10`` maps fractions onto the paper's 0–10
bars. Peaks are per dtype: bf16 and fp16 rows are held against the
tensor-core peak, f32 rows against the f32 peak *without* tensor cores
(the port keeps f32 true f32, TF32 off). The table is keyed by
``torch.cuda.get_device_name()``, since the SXM and PCIe parts differ.
A CPU run (no card name) is held against the H100 SXM, the suite's
roofline target, and its rows say so in ``CompiledInfo.peaks``; a card the
table does not list is refused rather than held against another card's
peaks.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "GpuPeaks",
    "H100_SXM",
    "H100_PCIE",
    "PEAKS",
    "peaks_for",
    "RooflineTerms",
    "roofline_terms",
    "utilization_scale10",
]


@dataclasses.dataclass(frozen=True)
class GpuPeaks:
    """Published dense peaks of one card at its full power limit."""

    name: str
    peak_bf16_flops: float  # tensor cores, dense, FLOP/s
    peak_f32_flops: float  # FP32 pipes without tensor cores, FLOP/s
    hbm_bw: float  # bytes/s

    def peak_flops(self, dtype: torch.dtype | None) -> float:
        """The peak a row of ``dtype`` is held against."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.peak_bf16_flops
        return self.peak_f32_flops


# NVIDIA H100 data sheet, dense rates without sparsity.
H100_SXM = GpuPeaks(
    name="NVIDIA H100 80GB HBM3",
    peak_bf16_flops=989e12,
    peak_f32_flops=67e12,
    hbm_bw=3.35e12,
)
H100_PCIE = GpuPeaks(
    name="NVIDIA H100 PCIe",
    peak_bf16_flops=756e12,
    peak_f32_flops=51e12,
    hbm_bw=2.0e12,
)
PEAKS = {p.name: p for p in (H100_SXM, H100_PCIE)}


def peaks_for(device_name: str | None) -> GpuPeaks:
    """The peak row for a card name; ``None`` (a CPU run) gets the H100 SXM.

    Raises ``ValueError`` for a card name the table does not list.
    """
    if device_name is None:
        return H100_SXM
    if device_name not in PEAKS:
        raise ValueError(
            f"no peak table row for {device_name!r} (listed: {sorted(PEAKS)}); "
            "add its data-sheet peaks to repro_torch.core.metrics.PEAKS"
        )
    return PEAKS[device_name]


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Roofline terms for one program on one device (no collectives yet:
    the port runs on one device, so ``collective_*`` are zero)."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.__getitem__)

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the larger term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def arithmetic_intensity(self) -> float:
        """FLOPs per HBM byte."""
        return self.flops / max(self.hbm_bytes, 1.0)


def roofline_terms(
    flops: float,
    bytes_moved: float,
    *,
    dtype: torch.dtype | None = None,
    hw: GpuPeaks = H100_SXM,
) -> RooflineTerms:
    """Roofline terms from analytic counts and the dtype's peak."""
    return RooflineTerms(
        flops=float(flops),
        hbm_bytes=float(bytes_moved),
        collective_bytes=0.0,
        compute_s=float(flops) / hw.peak_flops(dtype),
        memory_s=float(bytes_moved) / hw.hbm_bw,
        collective_s=0.0,
    )


def utilization_scale10(fraction: float) -> int:
    """Map a roofline fraction onto the paper's 0–10 utilization bar scale."""
    return max(0, min(10, round(10.0 * fraction)))
