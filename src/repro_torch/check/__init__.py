"""Static contract checker for the PyTorch port (``python -m repro_torch.check``).

The port's own copy of ``repro/check``, its rules aimed at
``src/repro_torch/``. Parses the tree with the stdlib ``ast`` module — no
imports of the checked code, no third-party dependencies — and enforces the
invariants the port's correctness rests on: workload/kernel registration
contracts, cache-key completeness, stage-timing discipline, record-schema
stability, lock discipline in the serving, observability, distribution and
kernel-build layers, and the wire protocol's registry.
"""

from repro_torch.check.core import Checker, Context, Finding, all_checkers, run_checks

__all__ = ["Checker", "Context", "Finding", "all_checkers", "run_checks"]
