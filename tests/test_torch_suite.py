"""The port's main path (plan → engine → records) against the reference.

For each benchmark of the slice, the reference's Workload at preset 0 makes
the inputs, and the same values (carried across by
``repro_torch.convert.from_reference``) go through the reference's ``fn``
and the port's, under the kernel route (the plain versions on the CPU).
Then the port's engine runs end to end on the CPU with ``impl="kernel"``
into a JSONL report that both packages' loaders read. The plan-validation
cases of ``test_engine.py`` / ``test_placement.py`` that apply to one
device are replayed against the port's plan.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.core.registry import get_benchmark as ref_benchmark
from repro.core.results import load_run as ref_load_run
from repro_torch.convert import from_reference
from repro_torch.core import suite
from repro_torch.core.engine import Engine, bind_impl
from repro_torch.core.plan import ExecutionPlan, Placement, PlanError
from repro_torch.core.registry import BenchmarkSpec, Workload, all_benchmarks, get_benchmark
from repro_torch.core.results import SCHEMA_VERSION, BenchmarkRecord, load_run
from repro_torch.kernels import matmul as tmatmul
from repro_torch.kernels import softmax as tsoftmax

SLICE = (
    "gemm_f32_nn", "gemm_f32_tn", "gemm_bf16_nn", "gemm_bf16_tn",
    "maxflops_bf16", "maxflops_f32", "connected", "softmax",
)
FAST = dict(preset=0, iters=2, warmup=1, device="cpu")


def _plan(**kw):
    return ExecutionPlan(**{**FAST, **kw})


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tol(name: str) -> float:
    # The reference's kernel tolerances: 2e-2 for bf16, 1e-5 for f32.
    return 2e-2 if "bf16" in name else 1e-5


def test_registry_holds_exactly_the_slice():
    assert sorted(s.name for s in all_benchmarks()) == sorted(SLICE)
    for name in SLICE:
        spec, ref = get_benchmark(name), ref_benchmark(name)
        assert (spec.level, spec.dwarf, spec.domain, spec.cuda_feature) == (
            ref.level, ref.dwarf, ref.domain, ref.cuda_feature
        )
        assert spec.presets == ref.presets
        wl, rwl = spec.build_preset(0), ref.build_preset(0)
        assert wl.name == rwl.name
        assert (wl.flops, wl.bytes_moved, wl.batch_dims) == (
            rwl.flops, rwl.bytes_moved, rwl.batch_dims
        )
        assert wl.kernel == rwl.pallas_kernel


@pytest.mark.parametrize("name", SLICE)
def test_forward_matches_reference_on_the_same_inputs(name):
    rwl = ref_benchmark(name).build_preset(0)
    rargs = rwl.make_inputs(0)
    want = jax.jit(rwl.fn)(*rargs)
    wl = get_benchmark(name).build_preset(0)
    args = from_reference([np.asarray(a) for a in rargs], "cpu")
    got = bind_impl(wl.fn, wl, "kernel")(*args)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert tuple(got.shape) == tuple(want.shape)
    tol = _tol(name)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)
    if wl.validate is not None:
        wl.validate(got, args)


@pytest.mark.parametrize("name", ["connected", "softmax"])
def test_backward_matches_reference_on_the_same_inputs(name):
    rwl = ref_benchmark(name).build_preset(0)
    rargs = rwl.make_inputs(0)
    want = jax.jit(rwl.fn_bwd)(*rargs)
    wl = get_benchmark(name).build_preset(0)
    args = from_reference([np.asarray(a) for a in rargs], "cpu")
    got = bind_impl(wl.fn_bwd, wl, "torch")(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np32(g), _np32(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", SLICE)
def test_make_inputs_match_the_reference_in_shape_and_dtype(name):
    ref_args = ref_benchmark(name).build_preset(0).make_inputs(0)
    wl = get_benchmark(name).build_preset(0)
    args = wl.make_inputs(0)
    assert [tuple(a.shape) for a in args] == [tuple(a.shape) for a in ref_args]
    assert [str(a.dtype).replace("torch.", "") for a in args] == [
        str(a.dtype) for a in ref_args
    ]
    again, other = wl.make_inputs(0), wl.make_inputs(1)
    assert all(torch.equal(a, b) for a, b in zip(args, again, strict=True))
    assert not torch.equal(args[0], other[0])


def _calls_per_pass(plan: ExecutionPlan) -> int:
    # compile's first call + validate + warm-up + timed + windowed calls
    return 1 + 1 + plan.warmup + plan.iters * (1 + plan.timing_window)


def test_kernel_run_on_cpu_end_to_end(tmp_path):
    path = str(tmp_path / "run.jsonl")
    rc = suite.main([
        "--names", *SLICE, "--preset", "0", "--iters", "2", "--warmup", "1",
        "--impl", "kernel", "--device", "cpu", "--jsonl", path,
    ])
    assert rc == 0
    meta, records = load_run(path)
    assert meta.backend == "cpu" and meta.jax_version is None
    assert meta.impl == "kernel" and meta.schema_version == SCHEMA_VERSION
    assert meta.allow_tf32_matmul is False and meta.allow_tf32_cudnn is False
    fwd = [r for r in records if not r.name.endswith(".bwd")]
    bwd = [r for r in records if r.name.endswith(".bwd")]
    assert len(fwd) == len(SLICE) and len(bwd) == 2  # connected, softmax
    for r in fwd:
        assert r.status == "ok", r.error
        assert (r.impl, r.impl_interpret, r.impl_fallback) == ("kernel", True, None)
        assert r.us_per_call > 0 and r.us_per_call_windowed > 0
        assert set(r.stage_timings_us) == {
            "build", "place", "compile", "measure", "characterize"
        }
        assert "impl=kernel;interpret=1" in r.csv()
    for r in bwd:
        assert r.status == "ok", r.error
        assert (r.impl, r.impl_fallback) == ("torch", "backward_pass")
        assert r.impl_interpret is None
    # The reference's loader reads the port's report unchanged.
    ref_meta, ref_records = ref_load_run(path)
    assert ref_meta.jax_version is None and ref_meta.backend == "cpu"
    assert [r.name for r in ref_records] == [r.name for r in records]
    assert [r.us_per_call for r in ref_records] == [r.us_per_call for r in records]
    with open(path) as f:
        first = json.loads(f.readline())
    assert first["kind"] == "meta" and "jax_version" in first


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_force_impl_is_active_on_every_call(monkeypatch, impl):
    """Every call the measure stage makes (validate, warm-up, timed,
    windowed) goes through the kernel route on a kernel plan, and none on a
    torch plan."""
    plan = _plan(names=("maxflops_f32", "gemm_bf16_tn", "softmax"),
                 include_backward=False, impl=impl, iters=3, warmup=2,
                 timing_window=3)
    engine = Engine()
    deltas = []
    measure = engine._stage_measure

    def counted(workload, entry, args, plan, backward):
        before = tmatmul.plain_calls + tsoftmax.plain_calls
        out = measure(workload, entry, args, plan, backward)
        deltas.append(tmatmul.plain_calls + tsoftmax.plain_calls - before)
        return out

    monkeypatch.setattr(engine, "_stage_measure", counted)
    before = tmatmul.plain_calls + tsoftmax.plain_calls
    res = engine.run(plan)
    assert [r.status for r in res.records] == ["ok"] * 3
    per_measure = 1 + plan.warmup + plan.iters * (1 + plan.timing_window)
    per_call = [4, 1, 1]  # maxflops chains 4 matmuls; gemm, softmax one op
    if impl == "kernel":
        assert deltas == [n * per_measure for n in per_call]
        total = tmatmul.plain_calls + tsoftmax.plain_calls - before
        assert total == sum(per_call) * _calls_per_pass(plan)
    else:
        assert deltas == [0, 0, 0]


def test_compile_cache_builds_each_pass_once():
    engine = Engine()
    plan = _plan(names=("gemm_f32_nn", "softmax"), include_backward=True)
    res = engine.run(plan)
    assert [r.status for r in res.records] == ["ok"] * 3
    assert (engine.cache.misses, engine.cache.hits) == (3, 0)
    engine.run(plan)
    assert (engine.cache.misses, engine.cache.hits) == (3, 3)
    # Another implementation or override is another entry.
    engine.run(_plan(names=("gemm_f32_nn",), include_backward=False, impl="kernel"))
    engine.run(_plan(names=("gemm_f32_nn",), include_backward=False,
                     overrides={"gemm_f32_nn": {"n": 128}}))
    assert engine.cache.misses == 5


_BROKEN = BenchmarkSpec(
    name="zz_broken_build", level=1, dwarf=None, domain=None, cuda_feature=None,
    gpu_feature=None, presets={0: {}},
    build=lambda: (_ for _ in ()).throw(RuntimeError("deliberately broken")),
)


def _broken_measure_spec() -> BenchmarkSpec:
    def build():
        return Workload(
            name="zz_broken_measure", fn=lambda x: x * 2,
            make_inputs=lambda seed: (torch.ones(3),),
            validate=lambda out, args: (_ for _ in ()).throw(AssertionError("bad\n output")),
        )

    return BenchmarkSpec(
        name="zz_broken_measure", level=1, dwarf=None, domain=None,
        cuda_feature=None, gpu_feature=None, presets={0: {}}, build=build,
    )


def test_fault_isolation_keeps_the_suite_going(tmp_path):
    path = str(tmp_path / "r.jsonl")
    res = Engine().run(
        _plan(specs=(_BROKEN, _broken_measure_spec(), get_benchmark("gemm_f32_nn")),
              include_backward=False),
        jsonl_path=path,
    )
    by_name = {r.name: r for r in res.records}
    assert by_name["zz_broken_build"].status == "error"
    assert by_name["zz_broken_build"].derived == "stage=build"
    assert "deliberately broken" in by_name["zz_broken_build"].error
    assert by_name["zz_broken_measure"].derived == "stage=measure"
    assert "\n" not in by_name["zz_broken_measure"].error
    assert "compile" in by_name["zz_broken_measure"].stage_timings_us
    assert len(res.ok_records) == 1
    assert [r.status for r in load_run(path)[1]] == ["error", "error", "ok"]


def test_kernel_plan_times_torch_for_workloads_without_a_kernel():
    spec = BenchmarkSpec(
        name="zz_no_kernel", level=1, dwarf=None, domain=None, cuda_feature=None,
        gpu_feature=None, presets={0: {}},
        build=lambda: Workload(name="zz_no_kernel", fn=lambda x: x * 2,
                               make_inputs=lambda seed: (torch.ones(3),)),
    )
    (rec,) = Engine().run(_plan(specs=(spec,), impl="kernel")).records
    assert rec.status == "ok"
    assert (rec.impl, rec.impl_fallback, rec.impl_interpret) == ("torch", "no_kernel", None)


def test_dnn_workload_inspects_inputs_when_not_told():
    from repro_torch.bench.dnn.common import dnn_workload

    wl = dnn_workload(
        "toy", lambda x, w, idx: (x @ w).sum(-1) + idx.float(),
        lambda seed: (torch.ones(2, 3), torch.ones(3, 4), torch.arange(2)),
        flops=1.0, bytes_moved=1.0,
    )
    assert wl.batch_dims == (0, None, None)
    gx, gw = wl.fn_bwd(torch.ones(2, 3), torch.ones(3, 4), torch.arange(2))
    torch.testing.assert_close(gx, torch.full((2, 3), 2.0))  # d mean / dx
    assert gw.shape == (3, 4) and wl.flops_bwd == 2.0


def test_plan_validation():
    with pytest.raises(ValueError, match="unknown benchmark"):
        ExecutionPlan(names=("not_a_benchmark",)).select()
    with pytest.raises(ValueError, match="iters"):
        ExecutionPlan(iters=0)
    with pytest.raises(ValueError, match="warmup"):
        ExecutionPlan(warmup=-1)
    with pytest.raises(ValueError, match="timing_window"):
        ExecutionPlan(timing_window=0)
    with pytest.raises(ValueError, match="devices"):
        ExecutionPlan(devices=0)
    with pytest.raises(PlanError, match="devices"):
        Engine().run(_plan(names=("gemm_f32_nn",), devices=4096))
    with pytest.raises(PlanError, match="impl"):
        ExecutionPlan(impl="pallas")
    with pytest.raises(PlanError, match="device"):
        ExecutionPlan(device="tpu")
    with pytest.raises(PlanError, match="serving"):
        ExecutionPlan(serve={"mode": "closed"})


def test_placement_validation_and_one_device_only():
    with pytest.raises(PlanError, match="mode"):
        Placement(devices=2, mode="bogus")
    with pytest.raises(PlanError, match="devices"):
        Placement(devices=0)
    with pytest.raises(PlanError, match="conflicting"):
        ExecutionPlan(devices=2, placement=Placement(devices=4))
    plan = ExecutionPlan(devices=2)
    assert plan.placement == Placement(devices=2, mode="replicate")
    assert plan.devices == 2
    with pytest.raises(PlanError, match="one device"):
        Engine().run(_plan(names=("gemm_f32_nn",),
                           placement=Placement(devices=1, mode="shard")))


def test_overrides_are_frozen_and_checked():
    with pytest.raises(ValueError, match="not hashable"):
        ExecutionPlan(overrides={"gemm_f32_nn": {"n": {"a": 1}}})
    plan = ExecutionPlan(overrides={"gemm_f32_nn": {"n": [512, 4]}})
    assert plan.overrides_for("gemm_f32_nn") == {"n": (512, 4)}


def test_cli_configuration_errors_exit_2(capsys):
    assert suite.main(["--names", "bogus", "--device", "cpu"]) == 2
    assert "bogus" in capsys.readouterr().err
    assert suite.main(["--names", "gemm_f32_nn", "--device", "cpu",
                       "--override", "nonsense"]) == 2


def test_cli_error_rows_exit_1(capsys):
    rc = suite.main(["--names", "gemm_f32_nn", "--device", "cpu", "--iters", "1",
                     "--warmup", "0", "--override", "gemm_f32_nn.bogus=1"])
    assert rc == 1
    assert "# ERROR gemm_f32_nn" in capsys.readouterr().err


def test_record_schema_matches_the_reference():
    from repro.core.results import BenchmarkRecord as RefRecord
    from repro.core.results import SCHEMA_VERSION as REF_SCHEMA

    assert SCHEMA_VERSION == REF_SCHEMA
    assert [f.name for f in dataclasses.fields(BenchmarkRecord)] == [
        f.name for f in dataclasses.fields(RefRecord)
    ]
    assert BenchmarkRecord.csv_header() == RefRecord.csv_header()
