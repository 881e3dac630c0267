"""Table I: the suite listing — level, dwarf, application domain, the
paper's new CUDA feature and what the port uses for it on Hopper, per
benchmark.

Counterpart of ``benchmarks/table1_suite.py``, whose ``tpu_feature=``
column names the reference's TPU analogue; here ``gpu_feature=`` names
the port's (``BenchmarkSpec.gpu_feature``).
"""

from __future__ import annotations

from repro_torch.benchmarks.common import Row
from repro_torch.core.registry import all_benchmarks


def rows() -> list[Row]:
    out: list[Row] = []
    for s in all_benchmarks():
        derived = (
            f"level={s.level};dwarf={s.dwarf or '-'};domain={s.domain or '-'};"
            f"cuda_feature={s.cuda_feature or '-'};gpu_feature={s.gpu_feature or '-'};"
            f"presets={len(s.presets)}"
        )
        out.append((f"table1.{s.name}", 0.0, derived))
    return out
