"""The port's serve stage against the reference's, on the CPU.

Pathfinder, Softmax and the f32 GEMM at preset 0 are served through both
engines (the port's on a kernel plan, whose kernel routes run their plain
versions here): closed and open loop, the single and the threaded client,
co-located, and mixed under every dispatch replaying one saved trace. Each
row must carry the reference's column set (the same serve columns filled,
the rest left empty), a replayed trace must serve the same requests in both
with the same bucket labels, and the width-1 call at the plan's own preset
must be the measure stage's callable (no new build).
"""

import dataclasses
import threading

import pytest
import torch

from repro.core.engine import Engine as JEngine
from repro.core.plan import ExecutionPlan as JPlan
from repro.core.plan import ServeSpec as JServe
from repro.core.plan import ShapeBucket as JBucket
from repro_torch.core import registry
from repro_torch.core.engine import Engine
from repro_torch.core.plan import ExecutionPlan, ServeSpec, ShapeBucket
from repro_torch.core.results import BenchmarkRecord, load_run
from repro_torch.kernels import _build
from repro_torch.serve.loadgen import open_loop_schedule, sample_mix, save_trace

NAMES = ("pathfinder", "softmax", "gemm_f32_nn")
FAST = dict(preset=0, iters=1, warmup=0, include_backward=False)
SERVE_COLUMNS = [
    f.name for f in dataclasses.fields(BenchmarkRecord)
    if f.name.startswith(("serve_", "latency_")) or f.name in (
        "achieved_qps", "offered_qps", "goodput_qps", "slowdown_vs_isolated",
        "dispatch_overhead_us", "lane_qps", "batch_occupancy", "padding_waste",
        "bucket_latency_us", "client_procs", "proc_qps")
]
# Per workload: a two-bucket mix of preset 0 and one narrower variant.
MIXES = {
    "pathfinder": ((0, 2.0, ()), (0, 1.0, (("cols", 128),))),
    "softmax": ((0, 2.0, ()), (0, 1.0, (("classes", 512),))),
    "gemm_f32_nn": ((0, 1.0, ()), (0, 2.0, (("n", 128),))),
}


@pytest.fixture(scope="module")
def engines():
    return JEngine(), Engine()


def _filled(rec) -> set[str]:
    return {c for c in SERVE_COLUMNS if getattr(rec, c) is not None}


def _serve_both(engines, names, tries=5, **serve):
    """Serve ``names`` through both engines, the window doubled (both
    engines served again) while a row of either served warm-up requests
    alone. On a loaded host a 0.15 s closed-loop window can close before
    one measured request completes (a co-located tenant gets half the
    spec's slots); the row is then an error row ("no measured completions")
    and says nothing about its columns. Every other error fails at once."""
    jeng, teng = engines
    for attempt in range(tries):
        jrecs = jeng.run(JPlan(names=names, serve=JServe(**serve), **FAST)).records
        trecs = teng.run(ExecutionPlan(names=names, serve=ServeSpec(**serve), impl="kernel",
                                       device="cpu", **FAST)).records
        bad = [r for r in jrecs + trecs if r.status != "ok"]
        if not bad or attempt == tries - 1 or not all(
                "no measured completions" in r.error for r in bad):
            break
        serve = dict(serve, duration_s=2 * serve["duration_s"])
    for r in jrecs + trecs:
        assert r.status == "ok", (r.name, r.error)
    return jrecs, trecs


SERVES = {
    "closed_single": dict(mode="closed", concurrency=4, lanes=2, duration_s=0.15),
    "closed_threaded": dict(mode="closed", concurrency=4, lanes=2, duration_s=0.15,
                            client="threaded"),
    "open_single_slo": dict(mode="open", qps=300.0, concurrency=8, lanes=2, duration_s=0.15,
                            slo_us=50_000.0),
    "open_threaded": dict(mode="open", qps=300.0, concurrency=8, lanes=3, duration_s=0.15,
                          client="threaded"),
}


@pytest.mark.parametrize("case", sorted(SERVES))
def test_served_rows_carry_the_reference_columns(engines, case):
    jrecs, trecs = _serve_both(engines, NAMES, **SERVES[case])
    assert [r.name.split(".")[0] for r in trecs] == [r.name.split(".")[0] for r in jrecs]
    for j, t in zip(jrecs, trecs):
        assert _filled(t) == _filled(j), t.name
        for col in ("serve_mode", "serve_lanes", "serve_client", "serve_dispatch",
                    "serve_slo_us", "offered_qps", "serve_truncated"):
            assert getattr(t, col) == getattr(j, col), col
        assert t.serve_requests > 0 and t.latency_p50_us <= t.latency_p99_us
        assert len(t.lane_qps) == t.serve_lanes
        assert t.stage_timings_us["serve"] > 0
        # The derived text's serve keys are the reference's, in its order.
        keys = [kv.split("=")[0] for kv in t.csv().split(";serve=", 1)[1].split(";")]
        want = [kv.split("=")[0] for kv in j.csv().split(";serve=", 1)[1].split(";")]
        assert keys == want


def test_colocated_pair_rows_agree(engines):
    serve = dict(mode="closed", concurrency=4, lanes=2, duration_s=0.15, colocate="gemm_f32_nn")
    jrecs, trecs = _serve_both(engines, ("pathfinder",), **serve)
    assert [r.name for r in trecs][1:] == [r.name for r in jrecs][1:] == [
        "gemm_f32_nn@pathfinder"]
    for j, t in zip(jrecs, trecs):
        assert _filled(t) == _filled(j)
        assert t.serve_colocate == j.serve_colocate and t.slowdown_vs_isolated > 0
        assert t.derived == j.derived if t.dominant == "serve" else True


def _trace(tmp_path, name):
    mix = MIXES[name]
    labels = {ShapeBucket(preset=p, weight=w, overrides=o).label: w for p, w, o in mix}
    sched = sample_mix(open_loop_schedule(qps=400.0, duration_s=0.12, seed=0, warmup=8),
                       labels, seed=0)
    path = str(tmp_path / f"{name}.jsonl")
    save_trace(sched, path)
    return mix, path, len([r for r in sched if not r.warmup])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dispatch", ["loop", "lanes", "batched", "dynamic"])
def test_mixed_serving_replays_one_trace_in_both_engines(engines, tmp_path, name, dispatch):
    mix, path, measured = _trace(tmp_path, name)
    serve = dict(mode="open", qps=400.0, concurrency=8, lanes=2, duration_s=0.12,
                 dispatch=dispatch, trace=path, max_batch=4, batch_budget_us=2000.0)
    jeng, teng = engines
    (j,) = jeng.run(JPlan(names=(name,), serve=JServe(
        mix=tuple(JBucket(preset=p, weight=w, overrides=o) for p, w, o in mix), **serve),
        **FAST)).records
    misses = teng.cache.misses
    (t,) = teng.run(ExecutionPlan(names=(name,), serve=ServeSpec(
        mix=tuple(ShapeBucket(preset=p, weight=w, overrides=o) for p, w, o in mix), **serve),
        impl="kernel", device="cpu", **FAST)).records
    assert j.status == t.status == "ok", (j.error, t.error)
    assert _filled(t) == _filled(j)
    assert t.serve_requests == j.serve_requests == measured
    assert set(t.bucket_latency_us) == set(j.bucket_latency_us)
    assert {k: v["requests"] for k, v in t.bucket_latency_us.items()} == {
        k: v["requests"] for k, v in j.bucket_latency_us.items()}
    assert (t.serve_mix, t.serve_dispatch, t.offered_qps) == (
        j.serve_mix, j.serve_dispatch, j.offered_qps)
    if dispatch in ("loop", "lanes"):
        assert t.batch_occupancy == 1.0 and t.serve_batches >= t.serve_requests
    # Built once per (bucket, width) on a fresh key: the width-1 call at the
    # plan's own preset is the measure stage's entry, never a new build.
    widths = {"loop": 1, "lanes": 1, "batched": 1, "dynamic": 3}[dispatch]
    assert teng.cache.misses - misses <= 1 + 2 * widths - (dispatch != "batched")


def test_width_one_at_the_plans_preset_is_the_measure_stages_callable():
    eng = Engine()
    serve = ServeSpec(mode="open", qps=200.0, duration_s=0.1, dispatch="loop",
                      mix=(ShapeBucket(preset=0),))
    (rec,) = eng.run(ExecutionPlan(names=("softmax",), serve=serve, impl="kernel",
                                   device="cpu", **FAST)).records
    assert rec.status == "ok", rec.error
    assert eng.cache.misses == 1  # the measure stage's build, served as it is


def test_a_width_w_call_that_cannot_be_batched_fails_the_row_naming_the_cause(monkeypatch):
    # Every registered row batches (the host-checked loops of BFS and
    # Mandelbrot through core/hostloop.py), so the row here is Softmax behind
    # a host check of its input, which torch.vmap refuses on a batched value.
    softmax = registry.get_benchmark("softmax")

    def build(**size):
        wl = softmax.build(**size)

        def fn(x):
            if not bool(torch.isfinite(x).all()):
                raise ValueError("non-finite logits")
            return wl.fn(x)

        return dataclasses.replace(wl, name="softmax_host_checked", fn=fn)

    spec = dataclasses.replace(softmax, name="softmax_host_checked", build=build)
    monkeypatch.setitem(registry._REGISTRY, spec.name, spec)
    serve = ServeSpec(mode="open", qps=200.0, duration_s=0.1, dispatch="batched", max_batch=2)
    (rec,) = Engine().run(ExecutionPlan(names=(spec.name,), serve=serve, impl="kernel",
                                        device="cpu", **FAST)).records
    assert rec.status == "error" and rec.derived == "stage=serve"
    assert "width-2 call under torch.vmap failed" in rec.error


def test_mixed_serving_refuses_host_transfer_rows_and_alien_trace_buckets(tmp_path):
    serve = ServeSpec(mode="open", qps=200.0, duration_s=0.1, dispatch="dynamic",
                      mix=(ShapeBucket(preset=0),))
    (rec,) = Engine().run(ExecutionPlan(names=("busspeeddownload",), serve=serve, device="cpu",
                                        **FAST)).records
    assert rec.status == "error" and "no_jit" in rec.error
    trace = str(tmp_path / "alien.jsonl")
    save_trace(sample_mix(open_loop_schedule(qps=200.0, duration_s=0.2, seed=0),
                          {"p9/zz=1": 1.0}, seed=0), trace)
    serve = ServeSpec(mode="open", qps=200.0, duration_s=0.1, dispatch="dynamic", trace=trace)
    (rec,) = Engine().run(ExecutionPlan(names=("softmax",), serve=serve, impl="kernel",
                                        device="cpu", **FAST)).records
    assert rec.status == "error" and "p9/zz=1" in rec.error


def test_jsonl_round_trips_the_serve_spec_and_rows(tmp_path):
    path = str(tmp_path / "served.jsonl")
    serve = ServeSpec(mode="open", qps=300.0, duration_s=0.1, dispatch="dynamic", max_batch=2,
                      mix=(ShapeBucket(preset=0, weight=2.0),
                           ShapeBucket(preset=0, overrides=(("classes", 512),))))
    res = Engine().run(ExecutionPlan(names=("softmax",), serve=serve, impl="kernel",
                                     device="cpu", **FAST), jsonl_path=path)
    meta, recs = load_run(path)
    assert meta.serve == serve
    assert recs == res.records and recs[0].bucket_latency_us


def test_suite_cli_serves_on_the_cpu(capsys):
    from repro_torch.core.suite import main

    rc = main(["--device", "cpu", "--names", "softmax", "gemm_f32_nn", "--impl", "kernel",
               "--serve", "closed", "--serve-client", "threaded", "--serve-duration", "0.1",
               "--iters", "1", "--warmup", "0", "--no-backward"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("serve=closed;client=threaded;lanes=2") == 2 and "dispatch_us=" in out
    rc = main(["--device", "cpu", "--names", "softmax", "--impl", "kernel", "--serve", "open",
               "--qps", "300", "--serve-duration", "0.1", "--serve-mix", "0@2,0/classes=512@1",
               "--serve-dispatch", "dynamic", "--max-batch", "2", "--iters", "1",
               "--warmup", "0", "--no-backward"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "dispatch=dynamic;occupancy=" in out and "buckets=p0:p50=" in out


def test_launch_counts_stay_exact_under_threads():
    counter = {"k": 0}

    def bump():
        for _ in range(20000):
            _build.count(counter, "k")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counter["k"] == 8 * 20000
