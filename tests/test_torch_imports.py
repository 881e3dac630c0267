"""The port stands alone: it imports neither JAX nor the JAX package (nor
``ml_dtypes``, which the card's machine does not have), and
without a CUDA card its entry points refuse to run instead of falling back
to the CPU.

Each check runs in a fresh interpreter, since this test process has JAX
and ``repro`` loaded already.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _run(args, **kw) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run(
        args, env=env, capture_output=True, text=True, timeout=300, **kw
    )


def _port_modules() -> list[str]:
    mods = []
    for path in sorted((SRC / "repro_torch").rglob("*.py")):
        parts = path.relative_to(SRC).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax_and_no_reference_module():
    mods = _port_modules()
    assert "repro_torch.core.engine" in mods and "repro_torch.kernels.matmul" in mods
    # The discovery finds modules by itself, in namespace packages too.
    assert {
        "repro_torch.kernels.prefix_scan", "repro_torch.kernels.srad_stencil",
        "repro_torch.kernels.bitonic_sort", "repro_torch.bench.level1.sort",
        "repro_torch.bench.level2.where", "repro_torch.bench.level2.srad",
        "repro_torch.kernels.flash_attention", "repro_torch.models", "repro_torch.models.config",
        "repro_torch.models.layers", "repro_torch.models.model", "repro_torch.configs",
        "repro_torch.configs.granite_3_8b", "repro_torch.configs.qwen1_5_0_5b",
        "repro_torch.configs.granite_8b", "repro_torch.configs.deepseek_7b",
        "repro_torch.models.moe", "repro_torch.configs.mixtral_8x22b",
        "repro_torch.configs.dbrx_132b", "repro_torch.core.hostloop",
        "repro_torch.launch", "repro_torch.launch.serve", "repro_torch.launch.dryrun",
        "repro_torch.launch.mesh", "repro_torch.launch.specs",
        "repro_torch.bench.level0.hostbus", "repro_torch.bench.level0.devicemem",
        "repro_torch.bench.level1.bfs", "repro_torch.bench.level2.mandelbrot",
        "repro_torch.bench.level2.particlefilter",
        "repro_torch.core.features", "repro_torch.kernels.managed",
        "repro_torch.kernels.mandelbrot", "repro_torch.obs", "repro_torch.obs.tracer",
        "repro_torch.serve", "repro_torch.serve.lanes", "repro_torch.serve.loadgen",
        "repro_torch.serve.latency", "repro_torch.benchmarks", "repro_torch.benchmarks.common",
        "repro_torch.benchmarks.run", "repro_torch.benchmarks.feat_hyperq",
        "repro_torch.benchmarks.feat_unified_memory", "repro_torch.benchmarks.feat_coop_groups",
        "repro_torch.benchmarks.feat_dynamic_parallelism",
        "repro_torch.core.hlocache", "repro_torch.benchmarks.table1_suite",
        "repro_torch.benchmarks.table2_dnn_kernels", "repro_torch.benchmarks.fig3_dnn_forward",
        "repro_torch.benchmarks.fig4_dnn_backward",
        "repro_torch.benchmarks.fig5_suite_utilization",
        "repro_torch.benchmarks.fig12_legacy_utilization", "repro_torch.benchmarks.fig_impl",
        "repro_torch.benchmarks.roofline_table",
        "repro_torch.serve.client", "repro_torch.serve.batcher",
        "repro_torch.serve.interference", "repro_torch.benchmarks.fig_concurrency",
        "repro_torch.benchmarks.fig_batching",
        "repro_torch.dist", "repro_torch.dist.proto", "repro_torch.dist.client_proc",
        "repro_torch.dist.launcher", "repro_torch.check", "repro_torch.check.__main__",
        "repro_torch.check.core", "repro_torch.check.contracts", "repro_torch.check.cachekey",
        "repro_torch.check.stages", "repro_torch.check.schema", "repro_torch.check.concurrency",
        "repro_torch.check.distproto", "repro_torch.benchmarks.fig_trace",
        "repro_torch.benchmarks.fig_dist",
        "repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.optim.clip",
        "repro_torch.optim.schedule", "repro_torch.data", "repro_torch.data.synthetic",
        "repro_torch.data.pipeline", "repro_torch.checkpoint",
        "repro_torch.checkpoint.checkpointer", "repro_torch.runtime",
        "repro_torch.runtime.steps", "repro_torch.runtime.straggler",
        "repro_torch.runtime.elastic", "repro_torch.launch.train", "repro_torch.convert",
    } <= set(mods)
    script = textwrap.dedent(f"""
        import importlib, sys
        for name in {mods!r}:
            importlib.import_module(name)
        from repro_torch.core.registry import all_benchmarks
        all_benchmarks()  # registers every ported benchmark
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "jaxlib", "repro", "ml_dtypes")
                     or m.startswith(("jax.", "jaxlib.", "repro.", "ml_dtypes.")))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    out = _run([sys.executable, "-c", script])
    assert out.returncode == 0, out.stdout + out.stderr


def test_suite_without_cuda_exits_2_instead_of_running_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    out = _run([sys.executable, "-m", "repro_torch.core.suite",
                "--names", "gemm_f32_nn", "--preset", "0"])
    assert out.returncode == 2, out.stdout + out.stderr
    assert "cuda" in out.stderr.lower()
    assert "gemm" not in out.stdout  # no row was measured anywhere


def test_checker_and_wire_format_import_neither_torch_nor_numpy():
    """``python -m repro_torch.check`` and ``dist/proto.py`` are stdlib only,
    like the reference's: the checker runs where torch is not installed,
    and a client can speak the protocol before any heavy import."""
    script = textwrap.dedent("""
        import sys
        from repro_torch.check import run_checks
        import repro_torch.check.__main__, repro_torch.dist.proto
        run_checks(sys.argv[1])
        heavy = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "numpy"))
        print("HEAVY", heavy)
        sys.exit(1 if heavy else 0)
    """)
    out = _run([sys.executable, "-c", script, str(ROOT)])
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("argv", [
    ["-m", "repro_torch.benchmarks.fig_trace"],
    ["-m", "repro_torch.benchmarks.fig_dist", "--procs", "2"],
    ["-m", "repro_torch.core.suite", "--names", "pathfinder", "--serve", "open",
     "--qps", "100", "--client-procs", "2"],
    ["-m", "repro_torch.launch.dryrun", "--arch", "xlstm-350m", "--shape", "long_500k"],
])
def test_trace_and_dist_entry_points_without_cuda_exit_2(argv):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    out = _run([sys.executable, *argv])
    assert out.returncode == 2, out.stdout + out.stderr
    assert "cuda" in out.stderr.lower()


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    out = _run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
