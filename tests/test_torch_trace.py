"""Tracing in the port's engine against the reference's, on the CPU.

The port's counterpart of ``tests/test_obs.py``'s engine cases: a stage is
one span recorded from the perf_counter pair that fills
``stage_timings_us`` (so the two are equal), an error record keeps its
partial timings, the counter snapshot is stamped into ``RunMetadata`` and
round-trips through JSONL, ``tune_trials_us`` is the sum of the trial
spans, served requests become events on lane tracks, and ``--trace-out``
writes a Chrome trace. The same small plan through both engines gives the
same span names and counter keys, and ``fig_trace`` the reference's rows.
"""

import inspect
import json

import pytest
import torch

from benchmarks import fig_trace as jfig_trace
import jax.numpy as jnp
from repro.core.engine import Engine as JEngine
from repro.core.plan import ExecutionPlan as JPlan
from repro.core.plan import ServeSpec as JServe
from repro.core.registry import BenchmarkSpec as JSpec
from repro.core.registry import Workload as JWorkload
from repro.obs import Tracer as JTracer
from repro_torch.benchmarks import fig_trace
from repro_torch.core import harness
from repro_torch.core import suite as tsuite
from repro_torch.core.engine import Engine
from repro_torch.core.plan import ExecutionPlan, ServeSpec
from repro_torch.core.registry import BenchmarkSpec, Workload
from repro_torch.core.results import load_run
from repro_torch.obs import NULL_TRACER, Tracer

FAST = dict(preset=0, iters=2, warmup=1, device="cpu")
STAGES = {"build", "place", "compile", "measure", "characterize"}


def _plan(**kw):
    return ExecutionPlan(**{**FAST, **kw})


def _spec(name="zz_trace"):
    """A tiny benchmark: serving it completes requests on a loaded host."""

    def build(**size):
        return Workload(
            name=name,
            fn=lambda x: x * 2.0 + 1.0,
            make_inputs=lambda seed: (torch.ones(8, 8),),
            flops=1.0,
            bytes_moved=1.0,
            batch_dims=(0,),
        )

    return BenchmarkSpec(
        name=name, level=0, dwarf=None, domain=None, cuda_feature=None,
        gpu_feature=None, presets={0: {}}, build=build,
    )


def _jspec(name="zz_trace"):
    """The reference's twin of :func:`_spec`."""

    def build(**size):
        return JWorkload(
            name=name,
            fn=lambda x: x * 2.0 + 1.0,
            make_inputs=lambda key: (jnp.ones((8, 8), jnp.float32),),
            flops=1.0,
            bytes_moved=1.0,
            batch_dims=(0,),
        )

    return JSpec(
        name=name, level=0, dwarf=None, domain=None, cuda_feature=None,
        tpu_feature=None, presets={0: {}}, build=build,
    )


@pytest.mark.parametrize("names,backward", [(("softmax",), False), (("lrn",), True)])
def test_one_span_a_stage_a_pass_equal_to_its_stage_timing(names, backward):
    tr = Tracer()
    res = Engine(tracer=tr).run(_plan(names=names, include_backward=backward,
                                      impl="kernel"))
    assert res.records and all(r.status == "ok" for r in res.records)
    for rec in res.records:
        spans = [e for e in tr.events() if e.track == "engine" and e.name in STAGES
                 and e.args["bench"] in (rec.name.split(".")[0], rec.name)]
        timings = rec.stage_timings_us
        assert set(timings) == STAGES
        per_pass = {e.name: e for e in spans if e.name not in ("build", "place")
                    and e.args["bench"].endswith(".bwd") == rec.name.endswith(".bwd")}
        shared = {e.name: e for e in spans if e.name in ("build", "place")}
        assert set(per_pass) | set(shared) == STAGES
        for stage, us in timings.items():
            span = per_pass.get(stage) or shared[stage]
            assert span.dur_us == pytest.approx(us, abs=1e-6)
    # one build and one place a benchmark, one of each other stage a pass
    counts = {s: sum(e.name == s for e in tr.events()) for s in STAGES}
    assert counts == {s: len(names) if s in ("build", "place") else len(res.records)
                      for s in STAGES}
    assert isinstance(res.metadata.counters, dict)


def test_the_default_engine_traces_nothing_and_stamps_no_counters():
    eng = Engine()
    assert eng.tracer is NULL_TRACER
    res = eng.run(_plan(specs=(_spec(),), include_backward=False))
    assert res.records[0].status == "ok" and res.metadata.counters is None
    assert set(res.records[0].stage_timings_us) == STAGES


def test_error_record_carries_partial_stage_timings_and_spans():
    def broken(**size):
        raise RuntimeError("no such workload")

    spec = BenchmarkSpec(name="zz_broken", level=0, dwarf=None, domain=None,
                         cuda_feature=None, gpu_feature=None, presets={0: {}},
                         build=broken)
    tr = Tracer()
    res = Engine(tracer=tr).run(_plan(specs=(spec, _spec())))
    err = [r for r in res.records if r.status != "ok"]
    assert len(err) == 1 and err[0].stage_timings_us.keys() == {"build"}
    (span,) = [e for e in tr.events() if e.args.get("bench") == "zz_broken"]
    assert span.name == "build"
    assert span.dur_us == pytest.approx(err[0].stage_timings_us["build"], abs=1e-6)


def test_counters_and_cache_stats_stamped_and_round_tripped(tmp_path):
    path = tmp_path / "run.jsonl"
    engine = Engine(cache_dir=str(tmp_path / "cache"), tracer=Tracer())
    plan = _plan(names=("gemm_f32_nn",), include_backward=False, impl="kernel", tune=True)
    res = engine.run(plan, jsonl_path=str(path))
    meta, (rec,) = load_run(str(path))
    assert rec.status == "ok" and rec.tune_trials == 2
    assert meta.counters == res.metadata.counters
    assert meta.cache_stats == res.metadata.cache_stats == {
        "tune_hits": 0, "tune_stores": 1, "tune_fallbacks": 0}
    assert meta.counters["tune.trials"] == 2
    for k, v in meta.cache_stats.items():
        assert meta.counters[f"cache.{k}"] == v
    # A warm run on the same engine: cumulative cache totals, set (not added)
    # into the snapshot.
    res2 = engine.run(plan)
    assert res2.records[0].tune_trials == 0
    assert res2.metadata.counters["cache.tune_hits"] == 1
    assert res2.metadata.counters["cache.tune_stores"] == 1


def test_tune_trials_us_is_the_sum_of_the_trial_spans(monkeypatch):
    monkeypatch.setattr(Engine, "_time_tune_trial", lambda self, e, a, p: 1.0)
    tr = Tracer()
    (rec,) = Engine(tracer=tr).run(_plan(names=("gemm_f32_nn",), include_backward=False,
                                         impl="kernel", tune=True)).records
    assert rec.status == "ok" and rec.tune_trials == 2
    trials = [e for e in tr.events() if e.name == "tune.trial"]
    assert len(trials) == rec.tune_trials
    assert [e.args["params"] for e in trials] == [
        {"block_m": 128, "block_n": 128}, {"block_m": 128, "block_n": 256}]
    assert rec.tune_trials_us == pytest.approx(sum(e.dur_us for e in trials), abs=1e-6)
    assert tr.counters.get("tune.trials") == rec.tune_trials


@pytest.mark.parametrize("serve", [
    dict(mode="closed", concurrency=4, lanes=2, duration_s=0.1),
    dict(mode="open", qps=300.0, concurrency=4, lanes=2, duration_s=0.1, client="threaded"),
    dict(mode="open", qps=300.0, concurrency=4, lanes=2, duration_s=0.1, dispatch="dynamic",
         max_batch=4),
])
def test_serve_events_on_lane_tracks(serve):
    tr = Tracer()
    (rec,) = Engine(tracer=tr).run(_plan(specs=(_spec(),), include_backward=False,
                                         serve=ServeSpec(**serve))).records
    assert rec.status == "ok", rec.error
    reqs = [e for e in tr.events() if e.name == "request"]
    assert reqs and all(e.track == "serve" for e in reqs)
    lanes = 1 if serve.get("dispatch") == "dynamic" else serve["lanes"]
    assert {e.tid for e in reqs} <= {f"lane {i}" for i in range(lanes)}
    assert tr.counters.get("serve.requests") == len(reqs)
    assert len(reqs) == rec.serve_requests + sum(e.args["warmup"] for e in reqs)
    assert "serve" in rec.stage_timings_us
    batches = [e for e in tr.events() if e.track == "batcher"]
    if serve.get("dispatch") == "dynamic":
        assert len(batches) == rec.serve_batches == tr.counters.get("batcher.flushes")
        assert all(e.tid.startswith("queue ") for e in batches)
        assert tr.counters.get("batcher.dispatched_slots") == sum(
            e.args["width"] for e in batches)
    else:
        assert not batches


def test_the_same_plan_gives_the_reference_span_names_and_counter_keys():
    """Both engines, each with one tracer: gemm_f32_nn tuned on its kernel
    route (the reference's Pallas kernel in interpret mode), then a tiny
    benchmark served closed loop. The same span names and counter keys. The
    ``lane.*`` counters count submits that found a lane full; the port's
    CPU calls are done when they return, so its lanes never fill here,
    while the reference's dispatch is asynchronous on the CPU too."""
    serve = dict(mode="closed", concurrency=4, lanes=2, duration_s=0.2)
    common = dict(preset=0, iters=1, warmup=0, include_backward=False)
    tune = dict(names=("gemm_f32_nn",), tune=True, **common)
    jt, tt = JTracer(), Tracer()
    jrecs = JEngine(tracer=jt).run(JPlan(impl="pallas", **tune)).records
    jrecs += JEngine(tracer=jt).run(JPlan(specs=(_jspec(),), serve=JServe(**serve),
                                          **common)).records
    trecs = Engine(tracer=tt).run(ExecutionPlan(impl="kernel", device="cpu", **tune)).records
    trecs += Engine(tracer=tt).run(ExecutionPlan(specs=(_spec(),), serve=ServeSpec(**serve),
                                                 device="cpu", **common)).records
    assert [r.status for r in jrecs + trecs] == ["ok"] * 4, [r.error for r in jrecs + trecs]
    assert {e.name for e in tt.events()} == {e.name for e in jt.events()}
    assert set(trecs[0].stage_timings_us) == set(jrecs[0].stage_timings_us)

    def keys(tracer):
        return {k for k in tracer.counters.snapshot() if not k.startswith("lane.")}

    assert keys(tt) == keys(jt) == {"serve.requests", "tune.trials"}


def test_timing_hot_loop_is_structurally_uninstrumented():
    src = inspect.getsource(harness)
    assert "tracer" not in src and "obs" not in src.replace("obs_", "")


def test_trace_out_cli_writes_a_chrome_trace(tmp_path, capsys):
    path = tmp_path / "run.trace.json"
    jsonl = tmp_path / "run.jsonl"
    rc = tsuite.main(["--device", "cpu", "--names", "softmax", "pathfinder", "--iters", "1",
                      "--warmup", "0", "--no-backward", "--trace-out", str(path),
                      "--jsonl", str(jsonl)])
    assert rc == 0
    err = capsys.readouterr().err
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    assert f"# trace: {len(spans)} spans -> {path}" in err
    assert sorted(e["name"] for e in spans) == sorted(list(STAGES) * 2)
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert {"engine", "main"} <= names
    meta, _ = load_run(str(jsonl))
    assert meta.counters == {}


def test_fig_trace_rows_are_the_references():
    """The port's rows are the reference's names, in its order, but for the
    reference's ``.tune`` rows: the port's untuned passes have no tune
    stage. Each row's share is of its pass, and every row carries the run's
    span count."""
    got = fig_trace.rows(iters=1, device="cpu", impl="kernel")
    want = jfig_trace.rows(iters=1)
    assert [n for n, _, _ in got] == [n for n, _, _ in want if not n.endswith(".tune")]
    assert fig_trace.STAGES == jfig_trace.STAGES
    assert fig_trace.DEFAULT_NAMES == jfig_trace.DEFAULT_NAMES
    spans = 3 * len(STAGES)  # the three passes' stages, nothing else
    for bench in {n.rsplit(".", 1)[0] for n, _, _ in got}:
        shares = [float(d.split(";")[0].removeprefix("share=")) for n, _, d in got
                  if n.rsplit(".", 1)[0] == bench]
        assert sum(shares) == pytest.approx(1.0, abs=0.01)
    assert all(d.endswith(f"spans={spans}") for _, _, d in got)


def test_fig_trace_empty_selection_exits_2(capsys):
    with pytest.raises(fig_trace.TraceFigureError):
        fig_trace.rows(names=(), device="cpu")
    assert fig_trace.main(["--device", "cpu", "--names"]) == 2
    assert "empty --names" in capsys.readouterr().err
