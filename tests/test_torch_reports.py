"""The port's report drivers against the reference's, on the CPU.

Each report module of ``repro_torch/benchmarks/`` (Table I, Table II,
Figs. 3, 4, 5 and 12, ``fig_impl``, ``roofline_table``'s suite-report mode
and ``run.py``'s sections for them) runs at preset 0 with
``device="cpu"``, where kernel rows run the kernels' plain versions, beside
the reference's module under ``benchmarks/`` (JAX on the CPU, Pallas in
interpret mode). Rows are
held to the reference's names, with the implementation axis renamed
(``xla`` to ``torch``, ``pallas`` to ``kernel``, Table II's ``.pallas``
suffix to ``.kernel``) and to the reference's derived keys. Table II's
counts are the port's analytic ones and are held to the reference
Workload's ``flops``/``flops_bwd`` and ``bytes_moved``.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

import benchmarks.fig3_dnn_forward as ref_fig3
import benchmarks.fig4_dnn_backward as ref_fig4
import benchmarks.fig5_suite_utilization as ref_fig5
import benchmarks.fig12_legacy_utilization as ref_fig12
import benchmarks.fig_impl as ref_fig_impl
import benchmarks.roofline_table as ref_roofline
import benchmarks.table1_suite as ref_table1
import benchmarks.table2_dnn_kernels as ref_table2
from repro.core.registry import get_benchmark as ref_get_benchmark
from repro.core.results import load_records as ref_load_records
from repro_torch.benchmarks import (
    common,
    fig3_dnn_forward,
    fig4_dnn_backward,
    fig5_suite_utilization,
    fig12_legacy_utilization,
    fig_impl,
    roofline_table,
    table1_suite,
    table2_dnn_kernels,
)
from repro_torch.core import suite
from repro_torch.core.engine import Engine
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.registry import get_benchmark
from repro_torch.core.results import load_records

ROOT = Path(__file__).resolve().parents[1]


def _renamed(name: str) -> str:
    """A reference row name on the port's implementation axis."""
    for old, new in ((".pallas", ".kernel"), (".xla", ".torch")):
        if name.endswith(old) or old + "." in name:
            name = name.replace(old, new)
    return name


def _keys(derived: str) -> list[str]:
    return list(common.parse_derived(derived))


# -- Table I --------------------------------------------------------------------


def test_table1_rows_match_the_reference():
    ours, theirs = table1_suite.rows(), ref_table1.rows()
    assert [n for n, _, _ in ours] == [n for n, _, _ in theirs]
    for (name, us, got), (_, _, want) in zip(ours, theirs):
        g, w = common.parse_derived(got), common.parse_derived(want)
        assert us == 0.0
        for key in ("level", "dwarf", "domain", "cuda_feature", "presets"):
            assert g[key] == w[key], (name, key)
        # The port names a Hopper feature wherever the reference names a TPU one.
        assert "tpu_feature" not in g and (g["gpu_feature"] == "-") == (w["tpu_feature"] == "-")


# -- Table II -------------------------------------------------------------------


@functools.cache
def _table2():
    return table2_dnn_kernels.rows(preset=1, device="cpu"), ref_table2.rows(preset=1)


def test_table2_has_the_references_layers_and_implementations():
    ours, theirs = _table2()
    assert [n for n, _, _ in ours] == [_renamed(n) for n, _, _ in theirs]
    assert [_keys(d) for _, _, d in ours] == [_keys(d) for _, _, d in theirs]
    for name, _, derived in ours:
        fields = common.parse_derived(derived)
        assert fields["impl"] == ("kernel" if ".kernel" in name else "torch")
        assert fields["kernel"].startswith(fields["impl"] + ":")
        assert "MXU" not in fields["kernel"] and "pallas" not in fields["kernel"]


def test_table2_counts_are_the_reference_workloads_analytic_counts():
    ours, _ = _table2()
    for name, _, derived in ours:
        layer = name.split(".")[1]
        w = ref_get_benchmark(layer).build_preset(1)
        fields = common.parse_derived(derived)
        flops = w.flops_bwd if name.endswith(".bwd") else w.flops
        assert fields["flops"] == f"{flops:.3e}", name
        assert fields["bytes"] == f"{w.bytes_moved:.3e}", name
        assert fields["ai"] == f"{flops / max(w.bytes_moved, 1.0):.2f}", name


def test_table2_classifies_convolution_compute_and_batchnorm_memory():
    # The paper's §V-A check (benchmarks/table2_dnn_kernels.py:6-8).
    dominant = {n: common.parse_derived(d)["dominant"] for n, _, d in _table2()[0]}
    for name in ("convolution_im2col", "convolution_im2col.kernel", "convolution_im2col.bwd",
                 "convolution_xla", "convolution_xla.bwd"):
        assert dominant[f"table2.{name}"] == "compute", name
    for name in ("batchnorm", "batchnorm.bwd"):
        assert dominant[f"table2.{name}"] == "memory", name


def test_characterize_shares_the_runs_cache_and_does_not_time():
    spec = get_benchmark("softmax")
    plan = ExecutionPlan(names=("softmax",), preset=0, iters=1, warmup=0,
                         include_backward=False, impl="kernel", device="cpu")
    eng = Engine()
    (rec,) = eng.run(plan).records
    hits = eng.cache.hits
    info = eng.characterize(spec, plan)
    assert eng.cache.hits == hits + 1 and eng.cache.misses == 1
    assert info.roofline.dominant == rec.dominant
    cold = Engine()
    info2 = cold.characterize(spec, plan, backward=True)  # a kernel plan's backward: torch
    assert cold.cache.misses == 1 and info2.name == rec.name + ".bwd"
    assert next(iter(cold.cache._entries))[7] == "torch"


# -- Figs. 3, 4, 5, 12 ----------------------------------------------------------

FIGS = {
    "fig3": (fig3_dnn_forward.rows, ref_fig3.rows),
    "fig4": (fig4_dnn_backward.rows, ref_fig4.rows),
    "fig5": (fig5_suite_utilization.rows, ref_fig5.rows),
    "fig12": (fig12_legacy_utilization.rows, ref_fig12.rows),
}


@pytest.mark.parametrize("section", sorted(FIGS))
def test_figure_rows_match_the_reference(section):
    port, ref = FIGS[section]
    ours, theirs = port(preset=0, device="cpu"), ref(preset=0)
    assert not [r for r in ours if r[2].startswith(common.ERROR_PREFIX)]
    assert [n for n, _, _ in ours] == [n for n, _, _ in theirs]
    assert [_keys(d) for _, _, d in ours] == [_keys(d) for _, _, d in theirs]
    assert all(n.startswith(section + ".") and us > 0 for n, us, _ in ours)


# -- fig_impl -------------------------------------------------------------------


def test_fig_impl_rows_match_the_reference():
    ours, theirs = fig_impl.rows(preset=0, device="cpu"), ref_fig_impl.rows(preset=0)
    assert [n for n, _, _ in ours] == [_renamed(n) for n, _, _ in theirs]
    for (name, _, got), (_, _, want) in zip(ours, theirs):
        # "tuned" shows non-empty parameters: the reference's softmax, LRN
        # and avgpool kernels have block parameters, the port's none.
        assert [k for k in _keys(got) if k != "tuned"] == [
            k.replace("_xla", "_torch") for k in _keys(want) if k != "tuned"], name
        fields = common.parse_derived(got)
        if name.endswith(".kernel"):
            assert fields["impl"] == "kernel" and fields["interpret"] == "1", name
            assert "speedup_vs_torch" in fields
        else:
            assert fields == {"impl": "torch"}, name
    kernel = {n: common.parse_derived(d) for n, _, d in ours if n.endswith(".kernel")}
    gemm = next(f for n, f in kernel.items() if n.startswith("fig_impl.gemm.f32.nn"))
    assert gemm["tune_trials"] == "2" and gemm["tuned"] in ("block_m=128/block_n=128",
                                                             "block_m=128/block_n=256")
    assert all(f["tune_trials"] == "0" for n, f in kernel.items() if ".gemm." not in n)


def test_fig_impl_without_tuning_has_no_tune_columns():
    ours = fig_impl.rows(preset=0, names=("gemm_f32_nn",), tune=False, device="cpu")
    assert [n for n, _, _ in ours] == ["fig_impl.gemm.f32.nn.n256.torch",
                                      "fig_impl.gemm.f32.nn.n256.kernel"]
    assert "tune" not in ours[1][2]
    with pytest.raises(fig_impl.ImplFigureError):
        fig_impl.rows(names=(), device="cpu")


def test_fig_impl_main_prints_the_pivot(capsys):
    assert fig_impl.main(["--device", "cpu", "--names", "gemm_f32_nn", "softmax"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["benchmark", "torch", "us", "kernel", "us", "speedup", "tuned"]
    assert [line.split()[0] for line in lines[1:]] == ["gemm.f32.nn.n256", "softmax.128x1024"]
    assert all(line.endswith("[interpret]") for line in lines[1:])
    assert fig_impl.main(["--device", "cpu", "--names", "nope"]) == 2


# -- roofline -------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_report(tmp_path_factory):
    """A port JSONL and JSON report of kernel and torch rows, on the CPU."""
    d = tmp_path_factory.mktemp("roofline")
    paths = (str(d / "r.jsonl"), str(d / "r.json"))
    suite.run_suite(names=["gemm_f32_nn", "softmax", "pathfinder", "busspeeddownload"],
                    preset=0, iters=1, warmup=0, impl="kernel", device="cpu",
                    include_backward=True, jsonl_path=paths[0], report_path=paths[1],
                    verbose=False)
    return paths


@pytest.mark.parametrize("fmt", ["jsonl", "json"])
def test_roofline_rows_from_a_port_report_match_the_references(port_report, fmt):
    path = port_report[0] if fmt == "jsonl" else port_report[1]
    ours, theirs = roofline_table.rows_from_report(path), ref_roofline.rows_from_report(path)
    # The reference suffixes pallas rows only; the port's kernel rows get .kernel.
    assert [n.removesuffix(".kernel") for n, _, _ in ours] == [n for n, _, _ in theirs]
    assert [(us, d) for _, us, d in ours] == [(us, d) for _, us, d in theirs]
    names = [n for n, _, _ in ours]
    assert "roofline.softmax.128x1024.kernel" in names and "roofline.softmax.128x1024.bwd" in names
    by_name = {n: d for n, _, d in ours}
    assert "timed=sync" in by_name["roofline.busspeeddownload.n1024"]
    assert "impl=kernel;interpret=1" in by_name["roofline.softmax.128x1024.kernel"]
    # The reference's loader reads the port's v9 report.
    assert [r.name for r in ref_load_records(path)] == [r.name for r in load_records(path)]


def test_roofline_error_rows_and_the_latest_report(tmp_path, monkeypatch, port_report):
    rec = load_records(port_report[0])[0]
    rec.status, rec.error = "error", "boom"
    assert roofline_table.rows_from_records([rec]) == [(f"roofline.{rec.name}", 0.0, "error=boom")]
    monkeypatch.setattr(roofline_table, "ARTIFACT_DIR", str(tmp_path))
    assert roofline_table.rows_from_latest_report() == []
    with open(port_report[1]) as src, open(tmp_path / "suite_report.json", "w") as dst:
        dst.write(src.read())
    assert roofline_table.rows_from_latest_report() == roofline_table.rows_from_report(
        port_report[1])
    (tmp_path / "suite_report.json").write_text("[{]")
    ((name, us, derived),) = roofline_table.rows_from_latest_report()
    assert name == "roofline.suite_report" and derived.startswith(common.ERROR_PREFIX)


# -- run.py ---------------------------------------------------------------------

REPORT_SECTIONS = ("table1", "table2", "fig3", "fig4", "fig5", "fig12", "fig_impl", "roofline")


def _run(*args, code=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = ["-c", code] if code else ["-m", "repro_torch.benchmarks.run", *args]
    return subprocess.run([sys.executable, *cmd], env=env, capture_output=True, text=True,
                          timeout=600, cwd=str(ROOT))


def test_run_report_sections_on_the_cpu_match_the_section_drivers():
    out = _run("--device", "cpu", "--preset", "0", "--sections", *REPORT_SECTIONS)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    rows = [line.split(",", 2) for line in lines[1:]]
    assert not [r for r in rows if r[2].startswith(common.ERROR_PREFIX)]
    prefixes = {n.split(".")[0] for n, _, _ in rows}
    # The roofline section renders the dry run's records (artifacts/dryrun_torch/,
    # single pod then multi-pod) and the suite report, where they exist; a
    # checkout has neither, so no roofline rows there.
    want = (roofline_table.rows("single") + roofline_table.rows("multi")
            + roofline_table.rows_from_latest_report())
    assert [n for n, _, _ in rows if n.startswith("roofline.")] == [n for n, _, _ in want]
    assert prefixes - {"roofline"} == set(REPORT_SECTIONS) - {"roofline"}
    assert [n for n, _, _ in rows if n.startswith("table2.")] == [
        n for n, _, _ in _table2()[0]]  # table2 at max(--preset, 1)
    for section in REPORT_SECTIONS:
        if section != "roofline":
            assert f"# section {section} done in " in out.stderr


def test_run_exits_2_on_an_unknown_section_before_importing_torch():
    code = ("import sys; from repro_torch.benchmarks import run; "
            "rc = run.main(['--sections', 'fig3', 'bogus']); "
            "print('torch' in sys.modules); sys.exit(rc)")
    out = _run(code=code)
    assert out.returncode == 2 and out.stdout.strip() == "False"
    assert "bogus" in out.stderr and "fig_impl" in out.stderr and "roofline" in out.stderr
