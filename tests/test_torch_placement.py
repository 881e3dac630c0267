"""Placement and device sweeps of the port, held to the reference's
``tests/test_placement.py``.

Plans, records and the CLI run in this process, where one device is
available (no process group). Several devices are the ranks of a gloo
world on the CPU (``tests/torch_world.py``), as the reference's
multi-device cases run on forced XLA host devices: every batchable
workload sharded against replicated at 2 and 4 ranks under both
implementations (the reference's tolerances, ``test_placement.py:
161-191``), each kernel op's sharding rule (local and gathered) against the
whole call, and the reference's four sweep tests (``:194-300``) in one
4-rank world.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro.core.registry import get_benchmark as ref_benchmark
from repro_torch.core.engine import Engine
from repro_torch.core.plan import ExecutionPlan, Placement, PlanError
from repro_torch.core.registry import Workload, all_benchmarks, get_benchmark
from repro_torch.core.results import SCHEMA_VERSION, BenchmarkRecord, RunMetadata
from repro_torch.runtime.sharding import place_args, workload_pspecs
from torch_world import run_world


# -- plans, records, the CLI (one process, one device) ------------------------


def test_placement_validation_and_plan_device_sweep():
    with pytest.raises(PlanError, match="mode"):
        Placement(devices=2, mode="bogus")
    with pytest.raises(PlanError, match="devices"):
        Placement(devices=0)
    plan = ExecutionPlan(devices=2)
    assert plan.placement == Placement(devices=2, mode="replicate")
    assert plan.devices == 2 and plan.device_sweep == (2,)
    with pytest.raises(PlanError, match="conflicting"):
        ExecutionPlan(devices=2, placement=Placement(devices=4))
    assert ExecutionPlan(device_sweep=(4, 1, 2, 2)).device_sweep == (1, 2, 4)
    for bad in ((), (0,), (1, 2.0)):
        with pytest.raises(PlanError, match="device_sweep"):
            ExecutionPlan(device_sweep=bad)
    plan = ExecutionPlan(placement=Placement(devices=1, mode="shard"), device_sweep=(1, 4))
    assert plan.placement_at(1) == Placement(devices=1, mode="replicate")
    assert plan.placement_at(4) == Placement(devices=4, mode="shard")


def test_batch_dims_declarations_match_input_arity_and_the_reference():
    checked = 0
    for spec in all_benchmarks():
        w = spec.build_preset(0)
        assert w.batch_dims == ref_benchmark(spec.name).build_preset(0).batch_dims, spec.name
        if w.batch_dims is None:
            continue
        args = w.make_inputs(0)
        assert len(w.batch_dims) == len(args), spec.name
        for dim, arg in zip(w.batch_dims, args):
            assert dim is None or (hasattr(arg, "shape") and len(arg.shape) > dim), spec.name
        checked += 1
    assert checked >= 5


def test_expected_batchability_split():
    batchable = {"gemm_f32_nn", "kmeans", "maxflops_bf16", "devicemem_stream",
                 "softmax", "connected", "activation", "mandelbrot_flat"}
    non_batchable = {"bfs", "sort", "gups", "nw", "busspeeddownload",
                     "mandelbrot_ms", "gemm_f32_tn"}
    for name in batchable:
        assert get_benchmark(name).build_preset(0).batchable, name
    for name in non_batchable:
        assert not get_benchmark(name).build_preset(0).batchable, name


def test_records_and_metadata_carry_the_placement_columns():
    assert SCHEMA_VERSION >= 2
    fields = {f.name for f in dataclasses.fields(BenchmarkRecord)}
    assert {"devices", "placement", "scaling_efficiency"} <= fields
    meta = RunMetadata(backend="cpu", device_count=1, device_sweep=[1, 2])
    assert meta.device_sweep == (1, 2)  # a JSON list comes back a tuple
    rec = BenchmarkRecord(name="x", level=0, dwarf=None, domain=None, preset=0,
                          us_per_call=2.0, achieved_gflops=0.0, achieved_gbps=0.0,
                          compute_util10=0, memory_util10=0, dominant="memory", devices=2,
                          placement="shard", scaling_efficiency=0.5)
    assert ";eff=0.500" in rec.csv()


def test_verbose_run_emits_csv_header_once_before_rows(capsys):
    Engine().run(ExecutionPlan(names=("devicemem_stream",), preset=0, iters=1, warmup=0,
                               include_backward=False, device="cpu"), verbose=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert lines[0] == BenchmarkRecord.csv_header()
    assert len(lines) == 2 and lines[1].startswith("devicemem.stream")


def test_shard_on_one_device_records_replicate():
    res = Engine().run(ExecutionPlan(
        names=("gemm_f32_nn", "bfs"), preset=0, iters=1, warmup=0, include_backward=False,
        device="cpu", placement=Placement(devices=1, mode="shard"), device_sweep=(1,)))
    assert [(r.status, r.devices, r.placement) for r in res.records] == [
        ("ok", 1, "replicate")] * 2
    assert [dataclasses.astuple(s) for s in res.sweep_stats] == [(1, 2, 0)]
    assert res.metadata.device_sweep == (1,) and res.metadata.placement == "shard"


def test_suite_cli_exits_2_with_the_device_count(capsys):
    from repro_torch.core.suite import main

    rc = main(["--device", "cpu", "--names", "gemm_f32_nn", "--devices", "4096"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "4096" in err and "available devices: 1" in err
    assert main(["--device", "cpu", "--names", "gemm_f32_nn", "--scale-devices", "1,4096"]) == 2
    assert "requests 4096 devices but only 1 available" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--names", "gemm_f32_nn", "--scale-devices", "1,x"])


def test_one_process_is_one_device():
    """Outside a process group: no torchrun world to join, one device, rank
    0, and a mesh of more devices refused naming both counts."""
    from repro_torch.runtime import sharding

    assert sharding.init_distributed("cpu") is False
    assert (sharding.available_devices(), sharding.rank()) == (1, 0)
    with pytest.raises(ValueError, match="requested 2 devices but only 1 available"):
        sharding.data_mesh(2)
    with pytest.raises(ValueError, match="= 4, but only 1 available"):
        sharding.host_data_mesh(2, 2)


def test_serving_and_mixed_serving_stay_on_one_device():
    from repro_torch.core.plan import ServeSpec

    for serve, match in ((ServeSpec(), "one device"),
                         (ServeSpec(mode="open", qps=10.0, dispatch="dynamic"), "single-device")):
        with pytest.raises(PlanError, match=match):
            Engine().run(ExecutionPlan(names=("softmax",), device="cpu", serve=serve,
                                       device_sweep=(1, 2)))


def test_workload_pspecs_requires_declaration_and_arity_fails_at_placement():
    w = Workload(name="opted_out", fn=lambda x: x, make_inputs=lambda seed: (1.0,))
    with pytest.raises(ValueError, match="batch_dims"):
        workload_pspecs(w, None)

    class _OneDevice:
        def size(self):
            return 1

    bad = Workload(name="bad_arity", fn=lambda x, y: x + y,
                   make_inputs=lambda seed: (torch.zeros(4), torch.zeros(4)), batch_dims=(0,))
    with pytest.raises(ValueError, match="declares 1 batch_dims"):
        place_args(bad.make_inputs(0), bad, _OneDevice(), "shard")


# -- several devices: gloo worlds on the CPU ----------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_matches_replicated_outputs(tmp_path, world):
    """Every workload with batch_dims, sharded against replicated, under
    both implementations, at the reference's tolerances: bf16 products
    re-tile per shard shape by ~1 ulp; f32 stays tight."""
    out = run_world("""
        import numpy as np
        from torch.distributed.tensor import DTensor
        from repro_torch.core.registry import all_benchmarks
        from repro_torch.kernels import ops
        from repro_torch.runtime.sharding import data_mesh, place_args

        mesh = data_mesh(WORLD)
        tols = {"maxflops_bf16": dict(rtol=2e-2, atol=5e-3)}
        names = []
        for impl in ("torch", "kernel"):
            for spec in all_benchmarks():
                w = spec.build_preset(0)
                if not w.batchable:
                    continue
                args = w.make_inputs(0)
                sharded, mode = place_args(args, w, mesh, "shard")
                assert mode == "shard", (spec.name, mode)
                replicated, rmode = place_args(args, w, mesh, "replicate")
                assert rmode == "replicate", (spec.name, rmode)
                replicated = tuple(a.to_local() if isinstance(a, DTensor) else a
                                   for a in replicated)
                with ops.force_impl("kernel" if impl == "kernel" else "ref"):
                    out_s, out_r = w.fn(*sharded), w.fn(*replicated)
                out_s = out_s if isinstance(out_s, tuple) else (out_s,)
                out_r = out_r if isinstance(out_r, tuple) else (out_r,)
                tol = tols.get(spec.name, dict(rtol=2e-5, atol=2e-5))
                for a, b in zip(out_s, out_r, strict=True):
                    assert isinstance(a, DTensor), spec.name
                    np.testing.assert_allclose(a.full_tensor().double().numpy(),
                                               b.double().numpy(), err_msg=spec.name, **tol)
                names.append(spec.name)
        print("checked", len(names) // 2, sorted(set(names)))
    """, world, tmp_path)
    assert "checked 18 " in out[0], out[0]


def test_op_sharding_rules_match_the_whole_call(tmp_path):
    """Each kernel op with DTensor operands: the local rule where the op is
    independent along the sharded dim, else gathered (a Partial operand
    reduced first), against the op on the whole tensors, each rule counted.
    Attention's head rule: q, k and v on their heads run locally; heads on q
    alone, or a KV head split across the ranks, gather."""
    out = run_world("""
        import numpy as np
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
        from repro_torch.kernels import ops
        from repro_torch.runtime.sharding import data_mesh

        mesh = data_mesh(WORLD)
        g = torch.Generator().manual_seed(0)

        def rnd(*shape):
            return torch.randn(*shape, generator=g)

        def d(t, dim):
            return distribute_tensor(t, mesh, [Replicate() if dim is None else Shard(dim)])

        img = rnd(4, 8, 8, 8)
        q, k, v = rnd(4, 4, 8, 16), rnd(4, 2, 8, 16), rnd(4, 2, 8, 16)
        k1, v1 = rnd(4, 1, 8, 16), rnd(4, 1, 8, 16)  # one KV head: split, it would misalign
        a, b, a3, b3 = rnd(8, 6), rnd(6, 4), rnd(4, 8, 6), rnd(4, 6, 4)
        flat = rnd(64)
        keys = torch.randperm(64, generator=g).to(torch.int32)
        srad_img = rnd(16, 16).abs() + 0.5
        cases = [  # (op, call on the whole tensors, call on DTensors, rule)
            ("matmul", lambda: ops.matmul(a, b), lambda: ops.matmul(d(a, 0), d(b, None)), "local"),
            ("matmul", lambda: ops.matmul(a, b), lambda: ops.matmul(d(a, None), d(b, 1)), "local"),
            ("matmul", lambda: ops.matmul(b.T, a3.transpose(1, 2)),
             lambda: ops.matmul(d(b.T.contiguous(), None), d(a3.transpose(1, 2).contiguous(), 0)),
             "local"),
            ("matmul", lambda: ops.matmul(a3, b3), lambda: ops.matmul(d(a3, 0), d(b3, 0)), "local"),
            ("matmul", lambda: ops.matmul(a, b), lambda: ops.matmul(d(a, 1), d(b, 0)), "gathered"),
            ("matmul", lambda: ops.matmul(a3, b), lambda: ops.matmul(d(a3, 0), d(b, 1)),
             "gathered"),
            ("attention", lambda: ops.attention(q, k, v, causal=True),
             lambda: ops.attention(d(q, 0), d(k, 0), d(v, 0), causal=True), "local"),
            ("attention", lambda: ops.attention(q, k, v),
             lambda: ops.attention(d(q, 1), d(k, 1), d(v, 1)), "local"),
            ("attention", lambda: ops.attention(q, k, v),
             lambda: ops.attention(d(q, 1), d(k, None), d(v, None)), "gathered"),
            ("attention", lambda: ops.attention(q, k1, v1),
             lambda: ops.attention(d(q, 1), d(k1, 1), d(v1, 1)), "gathered"),
            ("softmax", lambda: ops.softmax(a), lambda: ops.softmax(d(a, 0)), "local"),
            ("softmax", lambda: ops.softmax(a), lambda: ops.softmax(d(a, 1)), "gathered"),
            ("softmax", lambda: ops.softmax(a * WORLD),
             lambda: ops.softmax(DTensor.from_local(a, mesh, [Partial()])), "gathered"),
            ("lrn", lambda: ops.lrn(img, size=5), lambda: ops.lrn(d(img, 0), size=5), "local"),
            ("lrn", lambda: ops.lrn(img, size=5), lambda: ops.lrn(d(img, 2), size=5), "local"),
            ("lrn", lambda: ops.lrn(img, size=5), lambda: ops.lrn(d(img, 1), size=5), "gathered"),
            ("avgpool", lambda: ops.avgpool(img), lambda: ops.avgpool(d(img, 1)), "local"),
            ("avgpool", lambda: ops.avgpool(img), lambda: ops.avgpool(d(img, 2)), "gathered"),
            ("srad_step", lambda: ops.srad_step(srad_img),
             lambda: ops.srad_step(d(srad_img, None)), "local"),
            ("srad_step", lambda: ops.srad_step(srad_img),
             lambda: ops.srad_step(d(srad_img, 0)), "gathered"),
            ("prefix_scan", lambda: ops.prefix_scan(flat),
             lambda: ops.prefix_scan(d(flat, None)), "local"),
            ("prefix_scan", lambda: ops.prefix_scan(flat),
             lambda: ops.prefix_scan(d(flat, 0)), "gathered"),
            ("sort_kv", lambda: ops.sort_kv(keys, flat),
             lambda: ops.sort_kv(d(keys, 0), d(flat, 0)), "gathered"),
        ]
        for impl in ("kernel", "ref"):
            for op, whole, sharded, rule in cases:
                ops.dtensor_rules.clear()
                with ops.force_impl(impl):
                    want, got = whole(), sharded()
                assert dict(ops.dtensor_rules) == {(op, rule): 1}, (op, rule, ops.dtensor_rules)
                want = want if isinstance(want, tuple) else (want,)
                got = got if isinstance(got, tuple) else (got,)
                for x, y in zip(got, want, strict=True):
                    assert isinstance(x, DTensor), op
                    np.testing.assert_allclose(x.full_tensor().double().numpy(),
                                               y.double().numpy(), rtol=1e-5, atol=1e-6,
                                               err_msg=f"{op} {rule} {impl}")
        print("rules", len(cases))
    """, 2, tmp_path)
    assert "rules 23" in out[0]


def test_device_sweeps_in_one_four_rank_world(tmp_path):
    """The reference's four sweep tests, case for case: one record per
    (benchmark, pass, count) with the placement columns and
    scaling_efficiency, misses that do not increase; the JSONL round trip;
    no_jit rows staying on one device with one cache entry; a replicate
    sweep replicating every count. Rank 0 alone emits."""
    out = run_world("""
        import os
        from repro_torch.core.engine import Engine
        from repro_torch.core.plan import ExecutionPlan, Placement
        from repro_torch.core.results import load_run

        def plan(**kw):
            return ExecutionPlan(preset=0, iters=1, warmup=0, device="cpu", **kw)

        eng = Engine()
        res = eng.run(plan(names=("gemm_f32_nn", "bfs", "softmax"), include_backward=True,
                           placement=Placement(devices=1, mode="shard"),
                           device_sweep=(1, 2, 4)))
        if RANK == 0:
            assert not [r for r in res.records if r.status != "ok"], res.records
            # one record per (benchmark, pass, device count): 4 rows x 3 counts
            assert len(res.records) == 12, [r.name for r in res.records]
            for r in res.records:
                assert r.devices in (1, 2, 4), r
                if r.devices == 1 or r.name.startswith("bfs"):
                    assert r.placement == "replicate", r
                else:
                    assert r.placement == "shard", r
                if r.devices > 1:
                    assert r.scaling_efficiency is not None and r.scaling_efficiency > 0, r
                else:
                    assert r.scaling_efficiency is None, r
            assert [s.devices for s in res.sweep_stats] == [1, 2, 4]
            misses = [s.misses for s in res.sweep_stats]
            assert all(m2 <= m1 for m1, m2 in zip(misses, misses[1:])), misses
        else:
            assert res.records == [], res.records

        path = os.path.join(OUT, "sweep.jsonl")
        res = Engine().run(plan(names=("kmeans",), include_backward=False,
                                placement=Placement(devices=1, mode="shard"),
                                device_sweep=(1, 2)), jsonl_path=path)
        if RANK == 0:
            meta, recs = load_run(path)
            assert meta.placement == "shard" and meta.device_sweep == (1, 2), meta
            assert recs == res.records
            assert [r.devices for r in recs] == [1, 2]
            assert recs[1].scaling_efficiency is not None

        eng = Engine()
        res = eng.run(plan(names=("busspeeddownload",), include_backward=False,
                           placement=Placement(devices=1, mode="shard"),
                           device_sweep=(1, 2, 4)))
        if RANK == 0:
            assert [r.devices for r in res.records] == [1, 1, 1], res.records
            assert all(r.placement == "replicate" for r in res.records)
            assert all(r.scaling_efficiency is None for r in res.records)
            assert eng.cache.misses == 1, eng.cache.misses
        else:
            assert eng.cache.misses == 0, eng.cache.misses

        res = Engine().run(plan(names=("gemm_f32_nn",), include_backward=False,
                                device_sweep=(1, 2)))
        if RANK == 0:
            assert not [r for r in res.records if r.status != "ok"]
            assert [r.placement for r in res.records] == ["replicate", "replicate"]
            print("SWEEPS OK")
    """, 4, tmp_path)
    assert "SWEEPS OK" in out[0]
