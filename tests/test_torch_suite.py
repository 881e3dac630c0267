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

from repro.core.registry import all_benchmarks as ref_all_benchmarks
from repro.core.registry import get_benchmark as ref_benchmark
from repro.core.results import load_run as ref_load_run
from repro_torch.convert import from_reference
from repro_torch.core import suite
from repro_torch.core.engine import Engine, bind_impl
from repro_torch.core.plan import ExecutionPlan, Placement, PlanError
from repro_torch.core.registry import BenchmarkSpec, Workload, all_benchmarks, get_benchmark
from repro_torch.core.results import SCHEMA_VERSION, BenchmarkRecord, load_run
from repro_torch.kernels import avgpool as tavgpool
from repro_torch.kernels import bitonic_sort as tsort
from repro_torch.kernels import lrn as tlrn
from repro_torch.kernels import matmul as tmatmul
from repro_torch.kernels import prefix_scan as tscan
from repro_torch.kernels import softmax as tsoftmax
from repro_torch.kernels import srad_stencil as tsrad

FIRST_SLICE = (
    "gemm_f32_nn", "gemm_f32_tn", "gemm_bf16_nn", "gemm_bf16_tn",
    "maxflops_bf16", "maxflops_f32", "connected", "softmax",
)
# The rest of the DNN section; with connected and softmax, all of it.
DNN = (
    "convolution_xla", "convolution_im2col", "lrn", "pooling", "activation",
    "batchnorm", "rnn", "dropout",
)
# Sort, Where and SRAD: the level-1/2 benchmarks that have a kernel.
KERNEL_LEVELS = ("sort", "where", "srad")
# Levels 0-2 without a kernel; tests/test_torch_levels.py holds each against
# the reference at its own tolerance.
LEVELS = (
    "devicemem_stream", "devicemem_reduce", "devicemem_vmem", "busspeeddownload",
    "busspeedreadback", "bfs", "gups", "pathfinder", "cfd", "dwt2d_53", "dwt2d_97",
    "kmeans", "lavamd", "mandelbrot_flat", "mandelbrot_ms", "nw", "particlefilter",
)
SLICE = FIRST_SLICE + DNN + KERNEL_LEVELS + LEVELS
# Dropout's mask comes from another generator than the reference's: it is
# held by statistics (test_dropout_*), not element by element.
PARITY = tuple(name for name in FIRST_SLICE + DNN + KERNEL_LEVELS if name != "dropout")
BACKWARD = (
    "connected", "softmax", "lrn", "pooling", "activation", "batchnorm",
    "convolution_xla", "convolution_im2col", "rnn",
)
DNN_KERNEL_ROWS = ("convolution_im2col", "lrn", "pooling")  # the rest run torch
FAST = dict(preset=0, iters=2, warmup=1, device="cpu")


def _plan(**kw):
    return ExecutionPlan(**{**FAST, **kw})


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tol(name: str) -> float:
    # The reference's kernel tolerances: 2e-2 for bf16, 1e-5 for f32 (SRAD's
    # kernel test too); its convolution validate's 2e-4 (a 144-term f32 sum
    # in another order than XLA's convolution, bench/dnn/convolution.py:66);
    # Where's validate's 1e-6 (the records are copied, not computed). Integer
    # outputs (Sort's keys and values, Where's count) are compared exactly.
    if name.startswith("convolution"):
        return 2e-4
    if name == "where":
        return 1e-6
    return 2e-2 if "bf16" in name else 1e-5


def _leaves(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def test_registry_holds_exactly_the_slice():
    assert len(SLICE) == 36
    assert sorted(s.name for s in all_benchmarks()) == sorted(SLICE)
    assert sorted(s.name for s in ref_all_benchmarks()) == sorted(SLICE)
    for name in SLICE:
        spec, ref = get_benchmark(name), ref_benchmark(name)
        assert (spec.level, spec.dwarf, spec.domain, spec.cuda_feature) == (
            ref.level, ref.dwarf, ref.domain, ref.cuda_feature
        )
        assert spec.presets == ref.presets
        for preset in spec.presets:
            assert spec.build_preset(preset).name == ref.build_preset(preset).name
        wl, rwl = spec.build_preset(0), ref.build_preset(0)
        assert (wl.flops, wl.bytes_moved, wl.batch_dims) == (
            rwl.flops, rwl.bytes_moved, rwl.batch_dims
        )
        assert wl.kernel == rwl.pallas_kernel
        assert bool(wl.meta.get("no_jit")) == bool(rwl.meta.get("no_jit"))


@pytest.mark.parametrize("name", PARITY)
def test_forward_matches_reference_on_the_same_inputs(name):
    rwl = ref_benchmark(name).build_preset(0)
    rargs = rwl.make_inputs(0)
    want = jax.jit(rwl.fn)(*rargs)
    wl = get_benchmark(name).build_preset(0)
    args = from_reference([np.asarray(a) for a in rargs], "cpu")
    got = bind_impl(wl.fn, wl, "kernel")(*args)
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert len(got_leaves) == len(want_leaves)
    tol = _tol(name)
    for g, w in zip(got_leaves, want_leaves, strict=True):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        assert tuple(g.shape) == tuple(w.shape)
        if g.is_floating_point():
            np.testing.assert_allclose(_np32(g), _np32(w), rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if wl.validate is not None:
        wl.validate(got, args)


@pytest.mark.parametrize("name", BACKWARD)
def test_backward_matches_reference_on_the_same_inputs(name):
    # 1e-5 relative, 1e-6 absolute for every layer: at preset 0 the largest
    # difference is 2e-9. Batchnorm's gradient with respect to x is zero in
    # exact arithmetic (the mean of a normalised output does not depend on
    # x), so both packages give round-off of order 1e-12 there, which the
    # absolute term holds.
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
    if name == "busspeeddownload":
        # One more input: the device buffer the copy lands in, committed by
        # the place stage.
        assert len(args) == 2 and args[1].shape == args[0].shape
        args = args[:1]
    assert len(args) == len(ref_args)
    if name in ("dropout", "particlefilter"):
        # The reference's threefry key becomes a Python int seed.
        assert type(args[1]) is int
        args, ref_args = args[:1], ref_args[:1]
    assert [tuple(a.shape) for a in args] == [tuple(a.shape) for a in ref_args]
    assert [str(a.dtype).replace("torch.", "") for a in args] == [
        str(a.dtype) for a in ref_args
    ]
    again, other = wl.make_inputs(0)[: len(args)], wl.make_inputs(1)
    assert all(torch.equal(a, b) for a, b in zip(args, again, strict=True))
    # Mandelbrot's view is fixed: the seed changes nothing, as in the reference.
    assert torch.equal(args[0], other[0]) == name.startswith("mandelbrot")


def _calls_per_pass(plan: ExecutionPlan) -> int:
    # compile's first call + validate + warm-up + timed + windowed calls
    return 1 + 1 + plan.warmup + plan.iters * (1 + plan.timing_window)


def test_kernel_run_on_cpu_end_to_end(tmp_path):
    path = str(tmp_path / "run.jsonl")
    rc = suite.main([
        "--names", *FIRST_SLICE, "--preset", "0", "--iters", "2", "--warmup", "1",
        "--impl", "kernel", "--device", "cpu", "--jsonl", path,
    ])
    assert rc == 0
    meta, records = load_run(path)
    assert meta.backend == "cpu" and meta.jax_version is None
    assert meta.impl == "kernel" and meta.schema_version == SCHEMA_VERSION
    assert meta.allow_tf32_matmul is False and meta.allow_tf32_cudnn is False
    fwd = [r for r in records if not r.name.endswith(".bwd")]
    bwd = [r for r in records if r.name.endswith(".bwd")]
    assert len(fwd) == len(FIRST_SLICE) and len(bwd) == 2  # connected, softmax
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


def test_dnn_section_kernel_run_on_cpu_end_to_end(tmp_path):
    """The rest of the DNN section, forward and backward, as the smoke run
    drives it on the card: kernel rows ran the plain versions (flagged
    interpreted) on every call, the other rows and every backward pass
    timed torch and say why."""
    path = str(tmp_path / "dnn.jsonl")
    plain = {"matmul": tmatmul, "lrn": tlrn, "avgpool": tavgpool}
    before = {op: mod.plain_calls for op, mod in plain.items()}
    rc = suite.main([
        "--names", *DNN, "--preset", "0", "--iters", "2", "--warmup", "1",
        "--impl", "kernel", "--device", "cpu", "--jsonl", path,
    ])
    assert rc == 0
    meta, records = load_run(path)
    assert meta.backend == "cpu" and meta.impl == "kernel"
    assert len(records) == 2 * len(DNN)
    by_name = {get_benchmark(n).build_preset(0).name: n for n in DNN}
    for r in records:
        assert r.status == "ok", r.error
        backward = r.name.endswith(".bwd")
        bench = by_name[r.name.removesuffix(".bwd")]
        if bench not in DNN_KERNEL_ROWS:
            assert (r.impl, r.impl_fallback, r.impl_interpret) == ("torch", "no_kernel", None)
        elif backward:
            assert (r.impl, r.impl_fallback, r.impl_interpret) == ("torch", "backward_pass", None)
        else:
            assert (r.impl, r.impl_fallback, r.impl_interpret) == ("kernel", None, True)
    calls = _calls_per_pass(_plan())
    assert {op: mod.plain_calls - before[op] for op, mod in plain.items()} == {
        op: calls for op in plain
    }
    ref_meta, ref_records = ref_load_run(path)
    assert [r.name for r in ref_records] == [r.name for r in records]
    assert [r.impl_interpret for r in ref_records] == [r.impl_interpret for r in records]


def test_sort_where_srad_kernel_run_on_cpu_end_to_end(tmp_path):
    """Sort, Where and SRAD as the smoke run drives them on the card: every
    call of every pass ran the kernel route (the plain versions here, rows
    flagged interpreted); SRAD's four steps a call each went through it."""
    path = str(tmp_path / "levels.jsonl")
    mods = {"sort_kv": tsort, "prefix_scan": tscan, "srad_step": tsrad}
    before = {op: mod.plain_calls for op, mod in mods.items()}
    rc = suite.main([
        "--names", *KERNEL_LEVELS, "--preset", "0", "--iters", "2", "--warmup", "1",
        "--impl", "kernel", "--device", "cpu", "--jsonl", path,
    ])
    assert rc == 0
    meta, records = load_run(path)
    assert meta.backend == "cpu" and meta.impl == "kernel"
    assert [r.name for r in records] == ["sort.n4096", "srad.64x64.i4.fused", "where.n4096.f8"]
    for r in records:
        assert r.status == "ok", r.error
        assert (r.impl, r.impl_fallback, r.impl_interpret) == ("kernel", None, True)
    calls = _calls_per_pass(_plan())
    iters = get_benchmark("srad").presets[0]["iters"]
    assert {op: mod.plain_calls - before[op] for op, mod in mods.items()} == {
        "sort_kv": calls, "prefix_scan": calls, "srad_step": iters * calls,
    }
    ref_meta, ref_records = ref_load_run(path)
    assert [r.name for r in ref_records] == [r.name for r in records]


@pytest.mark.parametrize("value", ["false", "False", "0"])
def test_srad_split_through_the_override(tmp_path, value):
    """``--override srad.fused=false`` times the two-launch variant: the
    record names it, and the same plain steps ran."""
    path = str(tmp_path / "split.jsonl")
    before = tsrad.plain_calls
    rc = suite.main([
        "--names", "srad", "--preset", "0", "--iters", "2", "--warmup", "1",
        "--impl", "kernel", "--device", "cpu", "--override", f"srad.fused={value}",
        "--jsonl", path,
    ])
    assert rc == 0
    (rec,) = load_run(path)[1]
    assert rec.status == "ok", rec.error
    assert rec.name == "srad.64x64.i4.split"
    assert (rec.impl, rec.impl_interpret) == ("kernel", True)
    assert f"bytes={4 * 64 * 64 * 4 * 4:.3e}" in rec.csv()  # the reference's split count
    assert tsrad.plain_calls - before == 4 * _calls_per_pass(_plan())


def test_override_values_parse_bools_and_refuse_a_string_fused():
    assert suite._parse_overrides(["srad.fused=False", "srad.n=128", "x.y=TRUE", "x.z=0.5"]) == {
        "srad": {"fused": False, "n": 128}, "x": {"y": True, "z": 0.5},
    }
    with pytest.raises(TypeError, match="bool"):
        get_benchmark("srad").build_preset(0, fused="no")


def test_where_keeps_the_count_on_the_device_and_zeros_after_it():
    from repro_torch.bench.level2.where import where_select

    records = torch.tensor([[0.5, 1.0], [0.1, 2.0], [0.7, 3.0], [0.8, 4.0], [0.3, 5.0]])
    out, count = where_select(records, 0.25, 0.75)
    assert count.dtype == torch.int32 and count.dim() == 0 and int(count) == 3
    torch.testing.assert_close(out, torch.tensor(
        [[0.5, 1.0], [0.7, 3.0], [0.3, 5.0], [0.0, 0.0], [0.0, 0.0]]))


def test_sort_validate_catches_broken_pairs():
    wl = get_benchmark("sort").build_preset(0)
    keys, vals = wl.make_inputs(0)
    ko, vo = wl.fn(keys, vals)
    wl.validate((ko, vo), (keys, vals))
    with pytest.raises(AssertionError, match="pairs"):
        wl.validate((ko, vo.roll(1)), (keys, vals))
    with pytest.raises(AssertionError, match="sorted"):
        wl.validate((ko.flip(0), vo.flip(0)), (keys, vals))


def _dropout_inputs(rng):
    x = rng.standard_normal((256, 1024), dtype=np.float32)
    return x, jax.random.key(7)


def test_dropout_keeps_half_and_scales_in_both_packages(rng):
    from repro.bench.dnn.dropout import RATE as REF_RATE
    from repro.bench.dnn.dropout import dropout as ref_dropout
    from repro_torch.bench.dnn.dropout import RATE, dropout

    assert RATE == REF_RATE
    x, key = _dropout_inputs(rng)
    outs = {
        "reference": np.asarray(jax.jit(ref_dropout)(x, key)),
        "port": dropout(torch.from_numpy(x), 7).numpy(),
    }
    for who, out in outs.items():
        kept = out != 0
        assert abs(kept.mean() - (1 - RATE)) < 0.05, (who, kept.mean())
        np.testing.assert_allclose(out[kept], x[kept] / (1 - RATE), rtol=1e-6, err_msg=who)


def test_dropout_same_mask_seed_same_mask():
    from repro_torch.bench.dnn.dropout import dropout

    x = torch.from_numpy(np.random.default_rng(3).standard_normal((64, 512), dtype=np.float32))
    first, again, other = dropout(x, 11), dropout(x, 11), dropout(x, 12)
    assert torch.equal(first != 0, again != 0)
    assert not torch.equal(first != 0, other != 0)
    wl = get_benchmark("dropout").build_preset(0)
    args = wl.make_inputs(0)
    assert args[1] == wl.make_inputs(0)[1] != wl.make_inputs(1)[1]
    wl.validate(wl.fn(*args), args)


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
    with pytest.raises(PlanError, match="serve must be a ServeSpec"):
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
    # Shard at one device degenerates to replicate and runs; more devices
    # than this process's one raise, naming both counts.
    res = Engine().run(_plan(names=("gemm_f32_nn",),
                             placement=Placement(devices=1, mode="shard")))
    assert [(r.status, r.devices, r.placement) for r in res.records] == [("ok", 1, "replicate")]
    with pytest.raises(PlanError, match="requests 2 devices but only 1 available"):
        Engine().run(_plan(names=("gemm_f32_nn",), device_sweep=(1, 2)))


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
