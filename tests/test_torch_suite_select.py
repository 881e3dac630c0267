"""The suite's selectors and the package's re-exports against the reference.

``run_suite`` and the suite CLI select by tag and by domain as
``repro/core/suite.py`` does, and refuse alike what matches nothing; a call
without an engine runs on the shared ``DEFAULT_ENGINE``, so a second call
reuses what the first built; ``repro_torch.core`` re-exports the port's
counterpart of each name ``repro/core/__init__.py`` exports, without JAX.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.core import suite as ref_suite
from repro.core.plan import ExecutionPlan as RefPlan
from repro_torch.core import suite
from repro_torch.core.plan import ExecutionPlan

SRC = Path(__file__).resolve().parents[1] / "src"
# The reference's DNN section, the rows of domain "Deep Learning".
DNN_ROWS = (
    "activation", "batchnorm", "connected", "convolution_im2col", "convolution_xla",
    "dropout", "lrn", "pooling", "rnn", "softmax",
)
# The port's counterparts of repro/core/__init__.py's names (TPUv5e's is
# H100_SXM, time_workload's time_fn; compile_workload and
# collective_bytes_from_hlo have none).
REEXPORTS = (
    "run_suite", "Engine", "CompileCache", "RunResult", "ExecutionPlan", "Placement",
    "PlanError", "BenchmarkRecord", "RunMetadata", "JsonlReportWriter", "load_records",
    "load_run", "to_csv_lines", "write_report", "BenchmarkSpec", "Workload", "get_benchmark",
    "all_benchmarks", "register", "roofline_terms", "RooflineTerms", "utilization_scale10",
    "TimingResult", "H100_SXM", "GpuPeaks", "peaks_for", "time_fn",
)


def _names(plan_cls, **sel):
    try:
        return sorted(s.name for s in plan_cls(**sel).select())
    except ValueError as e:  # PlanError is a ValueError in both packages
        return f"refused: {str(e).split(' levels=')[0]}"


@pytest.mark.parametrize("sel", [
    {"domains": ("Deep Learning",)},
    {"tags": ("dnn",)},
    {"domains": ("Deep Learning",), "levels": (1,)},
    {"domains": ("Deep Learning", "Linear Algebra")},
    {"tags": ("bogus",), "domains": ("Deep Learning",)},
], ids=["dnn-domain", "dnn-tag", "dnn-domain-level1", "two-domains", "bogus-tag"])
def test_tags_and_domains_select_the_same_names_as_the_reference(sel):
    ours, theirs = _names(ExecutionPlan, **sel), _names(RefPlan, **sel)
    assert ours == theirs
    if sel == {"domains": ("Deep Learning",)}:
        assert tuple(ours) == DNN_ROWS
    if "tags" in sel:
        assert ours == "refused: no benchmarks match"


def test_run_suite_passes_tags_and_domains_to_the_plan():
    recs = suite.run_suite(domains=["Deep Learning"], names=["softmax", "lrn"], device="cpu",
                           preset=0, iters=1, warmup=0, include_backward=False,
                           verbose=False)
    assert sorted(r.name.split(".")[0] for r in recs) == ["lrn", "softmax"]
    assert all(r.status == "ok" for r in recs)
    for call in (suite.run_suite, ref_suite.run_suite):
        with pytest.raises(ValueError, match="no benchmarks match"):
            call(tags=["dnn"], iters=1, warmup=0, verbose=False)


def test_cli_parses_tags_and_domains_and_refuses_as_the_reference(capsys):
    base = ["--names", "softmax", "--preset", "0", "--iters", "1", "--warmup", "0",
            "--no-backward", "--device", "cpu"]
    assert suite.main(base + ["--domains", "Deep Learning"]) == 0
    assert capsys.readouterr().out.splitlines()[1].startswith("softmax.")
    assert suite.main(base + ["--domains", "Linear Algebra"]) == 2
    assert "no benchmarks match" in capsys.readouterr().err
    assert suite.main(["--device", "cpu", "--tags", "dnn"]) == 2
    ours = capsys.readouterr().err
    assert ref_suite.main(["--tags", "dnn"]) == 2
    theirs = capsys.readouterr().err
    assert "no benchmarks match" in ours and "no benchmarks match" in theirs
    assert ours.splitlines()[0] == theirs.splitlines()[0]


def test_a_second_run_suite_call_reuses_the_default_engine():
    assert isinstance(suite.DEFAULT_ENGINE, suite.Engine)
    kw = dict(names=["softmax"], device="cpu", preset=0, iters=1, warmup=0,
              include_backward=False, verbose=False)
    suite.run_suite(**kw)
    cache = suite.DEFAULT_ENGINE.cache
    hits, misses = cache.hits, cache.misses
    (rec,) = suite.run_suite(**kw)
    assert rec.status == "ok"
    assert cache.misses == misses and cache.hits > hits
    # An engine or a cache directory of the caller's own still takes the call.
    engine = suite.Engine()
    suite.run_suite(engine=engine, **kw)
    assert engine.cache.misses == 1 and cache.misses == misses


@pytest.mark.parametrize("names", [("run_suite", "Engine", "ExecutionPlan", "Placement"),
                                   REEXPORTS], ids=["acceptance", "all"])
def test_every_reexported_name_imports_without_jax(names):
    code = textwrap.dedent(f"""
        import sys
        from repro_torch.core import {", ".join(names)}
        import repro_torch.core as core
        assert core.run_suite.__module__ == "repro_torch.core.suite"
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_the_suite_cli_runs_as_a_module_without_a_double_import_warning():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-m", "repro_torch.core.suite", "--device", "cpu",
                        "--tags", "dnn"], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and "no benchmarks match" in r.stderr
    assert "RuntimeWarning" not in r.stderr
