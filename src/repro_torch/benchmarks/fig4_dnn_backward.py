"""Fig. 4: DNN backward-kernel utilization (gradients with respect to the
inputs and weights). Counterpart of ``benchmarks/fig4_dnn_backward.py``."""

from __future__ import annotations

from repro_torch.benchmarks.common import Row
from repro_torch.benchmarks.fig3_dnn_forward import rows as _fwd_rows


def rows(preset: int = 0, *, device: str = "cuda") -> list[Row]:
    return _fwd_rows(preset=preset, backward=True, device=device)
