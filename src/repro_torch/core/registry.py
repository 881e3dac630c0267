"""Benchmark registry — the suite's Table I as a first-class data structure.

Counterpart of ``repro/core/registry.py``. Mirovia/Altis organizes
benchmarks into *levels*:

- level 0: device microbenchmarks (bus speed, memory bandwidth, MaxFlops),
- level 1: basic parallel algorithms (GUPS, BFS, GEMM, Pathfinder, Sort),
- level 2: real application kernels (CFD, DWT2D, KMeans, LavaMD, Mandelbrot,
  NW, ParticleFilter, SRAD, Where) **plus the DNN section** (activation,
  pooling, batchnorm, connected, convolution, dropout, rnn, softmax, lrn),

with each benchmark tagged by Berkeley dwarf, application domain, and —
where applicable — the modern-platform feature it exercises. This module
stores that metadata and the factory that instantiates a benchmark at a
given problem size, so the suite runner, the preset system and the reports
consume one source of truth. The port registers the benchmarks it has
ported so far (``repro_torch/bench/__init__.py``).

**The ``batch_dims`` contract (for benchmark authors).** ``batch_dims`` is
a tuple with one entry per ``make_inputs`` output: the input's
data-parallel dimension index, or ``None`` for inputs that must be
replicated (weights, scalars); ``batch_dims=None`` opts the whole workload
out of sharding: a ``shard`` placement then falls back to ``replicate``
(``runtime/sharding.py::place_args``), and the record says so.

**The ``impl`` contract (for benchmark authors).** Plans carry an
``impl ∈ {"torch", "kernel"}`` axis selecting which implementation the
engine times:

- A benchmark opts in by setting ``kernel`` on its Workload to the name of
  the ``repro_torch.kernels.ops`` entry point its ``fn`` calls (a key of
  ``ops.KERNEL_OPS``). The fn keeps calling the op with the default
  ``mode="auto"``; the engine enters ``ops.force_impl`` around every call,
  so the declared kernel (or the plain oracle) runs.
- ``kernel=None`` (the default) means the workload has no hand-written
  kernel; ``--impl kernel`` plans time the torch path for it and the record
  says ``impl=torch`` with ``impl_fallback`` naming the reason.
- The kernel's tune space is its module's ``tune_space()`` (through
  ``ops.tune_space(kernel)``).
- The declaration is semantic: both implementations compute the same
  function (tests hold each kernel against its ``kernels/ref.py`` oracle).

**Host-transfer workloads (``meta["no_jit"]``).** A workload whose
benchmark is the transfer itself (the bus-speed rows) sets
``meta={"no_jit": True}``: the engine leaves its inputs on the host, times
it in sync mode only, gives it no roofline, and a kernel plan records
``impl_fallback="no_jit"``. ``meta["device_args"]`` names the input
positions the engine commits to the run's device all the same (a
destination buffer, a tensor to read back).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

__all__ = [
    "Workload",
    "BenchmarkSpec",
    "register",
    "get_benchmark",
    "all_benchmarks",
    "DNN_DOMAIN",
]

DNN_DOMAIN = "Deep Learning"


@dataclasses.dataclass
class Workload:
    """A benchmark instantiated at a concrete problem size.

    ``fn`` is a function of tensors; ``make_inputs`` builds the concrete
    input tensors (on the CPU) deterministically from a seed, and the
    engine moves them to the run's device once. ``flops`` /
    ``bytes_moved`` are *analytic* counts used to report achieved
    throughput and the roofline. ``validate`` optionally checks outputs for
    correctness (the suite runs it once, outside timing). ``batch_dims``
    declares the per-input data-parallel dims, and ``kernel`` names the
    workload's hand-written kernel entry point for the ``impl`` axis — see
    the module docstring for both contracts.
    """

    name: str
    fn: Callable[..., Any]
    make_inputs: Callable[[int], tuple]  # seed -> positional args for fn
    flops: float = 0.0
    bytes_moved: float = 0.0
    validate: Callable[[Any, tuple], None] | None = None
    # Differentiable workloads (the DNN section) also expose a backward fn.
    fn_bwd: Callable[..., Any] | None = None
    flops_bwd: float = 0.0
    # Per-input batch dim (None entry = replicate that input); None for the
    # whole field = non-batchable.
    batch_dims: tuple[int | None, ...] | None = None
    # Name of the repro_torch.kernels.ops entry point fn calls (impl
    # contract); None = no kernel, kernel plans time torch for this row.
    kernel: str | None = None
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def batchable(self) -> bool:
        """True when a sharded placement can partition at least one input."""
        return self.batch_dims is not None and any(d is not None for d in self.batch_dims)


@dataclasses.dataclass(frozen=True)
class BenchmarkSpec:
    """One Table-I row: identity + metadata + preset sizes + factory."""

    name: str
    level: int  # 0, 1, or 2 (DNN benchmarks are level 2, domain "Deep Learning")
    dwarf: str | None
    domain: str | None
    cuda_feature: str | None  # the paper's "New CUDA Feature" column
    gpu_feature: str | None  # what the port uses on Hopper for it
    presets: Mapping[int, Mapping[str, Any]]  # preset id (0..4) -> size kwargs
    build: Callable[..., Workload]  # build(**size_kwargs) -> Workload
    tags: tuple[str, ...] = ()

    def build_preset(self, preset: int, **overrides: Any) -> Workload:
        """Rodinia-style override on top of SHOC-style presets (§III-B)."""
        if preset not in self.presets:
            raise KeyError(
                f"benchmark {self.name!r} has presets {sorted(self.presets)}, "
                f"not {preset}"
            )
        kwargs = dict(self.presets[preset])
        unknown = set(overrides) - set(kwargs)
        if unknown:
            raise TypeError(
                f"benchmark {self.name!r} does not take size parameters {sorted(unknown)}; "
                f"valid: {sorted(kwargs)}"
            )
        kwargs.update(overrides)
        return self.build(**kwargs)


_REGISTRY: dict[str, BenchmarkSpec] = {}


def register(spec: BenchmarkSpec) -> BenchmarkSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate benchmark registration: {spec.name!r}")
    if spec.level not in (0, 1, 2):
        raise ValueError(f"benchmark {spec.name!r}: level must be 0/1/2, got {spec.level}")
    if not spec.presets:
        raise ValueError(f"benchmark {spec.name!r}: at least one preset size required")
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_loaded() -> None:
    # Benchmark modules self-register on import; importing the bench package
    # pulls in every ported level. Kept lazy so `import repro_torch.core`
    # stays light.
    import repro_torch.bench  # noqa: F401


def get_benchmark(name: str) -> BenchmarkSpec:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown benchmark {name!r}; known: {known}") from None


def all_benchmarks() -> Sequence[BenchmarkSpec]:
    _ensure_loaded()
    return sorted(_REGISTRY.values(), key=lambda s: (s.level, s.name))
