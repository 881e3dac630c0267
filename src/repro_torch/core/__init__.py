# The suite system of the port: registry (Table I), presets, plans, the
# staged engine, CUDA-event timing, roofline characterization and records.
#
# The reference's package (repro/core/__init__.py) re-exports the names
# below; each is re-exported here as the port's counterpart. Four of the
# reference's names are XLA or TPU objects:
# - TPUv5e: the port's peaks are the H100's, H100_SXM (a GpuPeaks row),
#   with peaks_for(card name) to pick the row of the card a run is on;
# - time_workload: the port times a callable, time_fn (CUDA events on a
#   card); the whole compile, validate and time of one workload is the
#   engine's (Engine.run);
# - compile_workload: left out. PyTorch runs eagerly, so there is no
#   compiled program to lower and analyse; the engine's build stage makes
#   the callable and characterize() gives its roofline terms;
# - collective_bytes_from_hlo: left out. There is no HLO to read; the dry
#   run reads a step's collectives off its trace as one rank of the mesh
#   (repro_torch.launch.dryrun.Trace), and states them for a step off
#   DTensors (repro_torch.launch.dryrun.collectives).
#
# run_suite is loaded on first use (PEP 562): the suite module is also the
# CLI (python -m repro_torch.core.suite), which must not find itself
# imported by its own package before it runs.

from repro_torch.core.registry import (  # noqa: F401
    BenchmarkSpec,
    Workload,
    all_benchmarks,
    get_benchmark,
    register,
)
from repro_torch.core.harness import TimingResult, time_fn  # noqa: F401
from repro_torch.core.metrics import (  # noqa: F401
    H100_SXM,
    GpuPeaks,
    RooflineTerms,
    peaks_for,
    roofline_terms,
    utilization_scale10,
)
from repro_torch.core.results import (  # noqa: F401
    BenchmarkRecord,
    JsonlReportWriter,
    RunMetadata,
    load_records,
    load_run,
    to_csv_lines,
    write_report,
)
from repro_torch.core.plan import ExecutionPlan, Placement, PlanError  # noqa: F401
from repro_torch.core.engine import CompileCache, Engine, RunResult  # noqa: F401


def __getattr__(name: str):
    if name == "run_suite":
        from repro_torch.core.suite import run_suite

        return run_suite
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
