"""The port's dispatch lanes, load generation, latency statistics and tracer
copy against the reference's (``repro.serve``, ``repro.obs``), on the CPU.

Load generation and latency statistics are numpy in both packages: the
same seed gives the same schedules and the same completions give the same
statistics, exactly. The lane tests mirror ``tests/test_serve.py``'s; the
CUDA-event side of the lanes (a result is ready when its event says so)
runs in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.obs import Tracer as RefTracer
from repro.serve import latency as ref_latency
from repro.serve import loadgen as ref_loadgen
from repro.serve.lanes import Completion as RefCompletion
from repro_torch.obs import Tracer, use_tracer
from repro_torch.serve import latency, loadgen
from repro_torch.serve.lanes import (
    Completion,
    DispatchLane,
    LaneSet,
    lane_depth,
    run_closed_loop,
    run_open_loop,
    serve_loop,
)


def _requests(schedule):
    return [dataclasses.astuple(r) for r in schedule]


def _schedule(s):
    return (_requests(s), s.offered_qps, s.truncated)


# -- loadgen: the reference's schedules, exactly ----------------------------


@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("qps,duration,cap", [(500.0, 0.5, 100_000), (1000.0, 10.0, 50),
                                              (3.0, 0.01, 100_000)])
def test_open_loop_schedule_equals_the_reference(seed, qps, duration, cap):
    kw = dict(qps=qps, duration_s=duration, seed=seed, warmup=3, max_requests=cap)
    got = loadgen.open_loop_schedule(**kw)
    want = ref_loadgen.open_loop_schedule(**kw)
    assert _schedule(got) == _schedule(want)


@pytest.mark.parametrize("seed", [0, 8])
@pytest.mark.parametrize("n_lanes,cap", [(1, 100_000), (4, 100_000), (4, 64)])
def test_lane_schedules_and_their_merge_equal_the_reference(seed, n_lanes, cap):
    kw = dict(qps=400.0, duration_s=0.5, n_lanes=n_lanes, seed=seed, warmup=5, max_requests=cap)
    got = loadgen.open_loop_lane_schedules(**kw)
    want = ref_loadgen.open_loop_lane_schedules(**kw)
    assert [_schedule(s) for s in got] == [_schedule(s) for s in want]
    assert _schedule(loadgen.merge_schedules(got)) == _schedule(ref_loadgen.merge_schedules(want))


def test_closed_loop_and_mix_equal_the_reference():
    assert _requests(loadgen.closed_loop_schedule(9, warmup=2)) == _requests(
        ref_loadgen.closed_loop_schedule(9, warmup=2))
    mix = {"p0/cols=64": 2.0, "p0/cols=128": 1.0}
    got = loadgen.sample_mix(loadgen.open_loop_schedule(qps=800.0, duration_s=0.25, seed=3), mix,
                             seed=3)
    want = ref_loadgen.sample_mix(ref_loadgen.open_loop_schedule(qps=800.0, duration_s=0.25,
                                                                 seed=3), mix, seed=3)
    assert _schedule(got) == _schedule(want)
    with pytest.raises(ValueError, match="n_requests"):
        loadgen.closed_loop_schedule(0)


def test_trace_round_trip_reads_the_reference_format(tmp_path):
    sched = ref_loadgen.sample_mix(
        ref_loadgen.open_loop_schedule(qps=300.0, duration_s=0.2, seed=1, warmup=2),
        [("a", 1.0), ("b", 3.0)], seed=1)
    path = str(tmp_path / "trace.jsonl")
    ref_loadgen.save_trace(sched, path)
    assert _schedule(loadgen.load_trace(path)) == _schedule(sched)
    loadgen.save_trace(loadgen.load_trace(path), str(tmp_path / "again.jsonl"))
    assert (tmp_path / "again.jsonl").read_text() == (tmp_path / "trace.jsonl").read_text()


# -- latency: the reference's statistics from the same completions ----------


def _completions(seed, n=120, lanes=3, buckets=False):
    rng = np.random.default_rng(seed)
    t0 = np.cumsum(rng.exponential(0.002, n))
    lat = rng.lognormal(-7.0, 0.6, n)
    out = []
    for i in range(n):
        kw = dict(index=i, lane=i % lanes, t_submit=float(t0[i]), t_done=float(t0[i] + lat[i]),
                  warmup=i < 5, bucket=("ab"[i % 2] if buckets else None))
        out.append((Completion(**kw), RefCompletion(**kw)))
    return [c for c, _ in out], [r for _, r in out]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kw", [{}, {"slo_us": 1000.0, "offered_qps": 400.0},
                                {"n_lanes": 4, "truncated": True, "dispatch_overhead_us": 3.5},
                                {"batch_occupancy": 0.75, "padding_waste": 0.1, "n_batches": 9}])
def test_latency_stats_equal_the_reference(seed, kw):
    ours, theirs = _completions(seed, buckets=bool(kw.get("n_batches")))
    got = latency.stats_from_completions(ours, **kw)
    want = ref_latency.stats_from_completions(theirs, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.derived() == want.derived()
    assert latency.lane_qps_from_completions(ours, n_lanes=5) == \
        ref_latency.lane_qps_from_completions(theirs, n_lanes=5)


def test_latency_stats_refuse_what_the_reference_refuses():
    with pytest.raises(ValueError, match="no completions"):
        latency.stats_from_completions([])
    warm = [Completion(index=0, lane=0, t_submit=0.0, t_done=1.0, warmup=True)]
    with pytest.raises(ValueError, match="no measured completions"):
        latency.stats_from_completions(warm)


# -- lanes (mirroring tests/test_serve.py) ----------------------------------


def test_lane_blocks_only_when_full_and_preserves_fifo():
    lane = DispatchLane(index=0, depth=2)
    r = lambda i: loadgen.Request(index=i)  # noqa: E731
    assert lane.submit("a", r(0), 0.0) == []
    assert lane.submit("b", r(1), 0.0) == []  # at depth, still no block
    done = lane.submit("c", r(2), 0.0)  # full: harvests its own oldest
    assert [c.index for c in done] == [0]
    assert [c.index for c in lane.drain()] == [1, 2]


def test_laneset_spreads_load_and_respects_capacity():
    lanes = LaneSet(n_lanes=3, depth=2)
    for i in range(6):
        assert lanes.submit(f"v{i}", loadgen.Request(index=i), 0.0) == []
    assert lanes.in_flight == 6 == lanes.capacity
    assert sorted(len(lane) for lane in lanes.lanes) == [2, 2, 2]
    done = lanes.drain()
    assert sorted(c.index for c in done) == list(range(6))


def test_lane_depth_validation():
    with pytest.raises(ValueError, match="depth"):
        DispatchLane(index=0, depth=0)
    with pytest.raises(ValueError, match="n_lanes"):
        LaneSet(n_lanes=0)
    assert lane_depth(8, 3) == 2 and lane_depth(1, 4) == 1


def test_full_lane_counts_its_blocked_submits_on_the_ambient_tracer():
    tracer = Tracer()
    lane = DispatchLane(index=0, depth=1)
    with use_tracer(tracer):
        for i in range(4):
            lane.submit(torch.ones(2), loadgen.Request(index=i), 0.0)
    assert tracer.counters.get("lane.submit_blocks") == 3
    assert tracer.counters.get("lane.submit_block_us") >= 0


@pytest.mark.parametrize("window", [1, 3])
def test_serve_loop_serves_every_request_in_order(window):
    calls = []

    def call():
        calls.append(len(calls))
        return torch.full((4,), float(len(calls)))

    done = serve_loop(call, loadgen.closed_loop_schedule(7, warmup=2), window=window)
    assert [c.index for c in done] == list(range(7)) and len(calls) == 7
    assert [c.warmup for c in done] == [True, True] + [False] * 5
    assert all(c.t_done >= c.t_submit and c.lane == 0 for c in done)
    if window == 3:  # a window's requests share its completion stamp
        assert done[0].t_done == done[2].t_done
    with pytest.raises(ValueError, match="window"):
        serve_loop(call, [], window=0)


def test_closed_and_open_loops_complete_every_request():
    done = run_closed_loop(lambda: torch.zeros(3), concurrency=4, n_lanes=2, duration_s=5.0,
                           warmup=2, max_requests=20)
    assert sorted(c.index for c in done) == list(range(20))
    assert {c.lane for c in done} == {0, 1}
    sched = loadgen.open_loop_schedule(qps=2000.0, duration_s=0.02, seed=0)
    done = run_open_loop(lambda: torch.zeros(3), sched, n_lanes=2, concurrency=4)
    assert sorted(c.index for c in done) == [r.index for r in sched]
    # Open loop: latency counts from the scheduled arrival.
    assert all(c.t_done >= c.t_submit for c in done)


# -- obs: the tracer copy behaves as the reference's -------------------------


def test_tracer_copy_exports_what_the_reference_exports(tmp_path):
    def drive(tracer):
        with tracer.span("compile", bench="gemm"):
            pass
        tracer.event("request", t_start=0.5, t_end=0.75, track="serve", tid="lane 0", index=3)
        tracer.counters.inc("cache.hits", 2)
        tracer.counters.set("lanes", 4)
        return tracer

    ours, theirs = drive(Tracer()), drive(RefTracer())

    def shape(events):  # all but the live span's clock readings
        return sorted((e["name"], e["ph"], e.get("cat", ""), e["pid"], e.get("tid", 0),
                       str(e["args"])) for e in events)

    assert shape(ours.chrome_events()) == shape(theirs.chrome_events())
    assert ours.counters.snapshot() == theirs.counters.snapshot()
    (req,) = [e for e in ours.events() if e.name == "request"]
    assert req.dur_us == pytest.approx(250000.0) and req.tid == "lane 0"
    assert ours.export_chrome(str(tmp_path / "t.json")) == 2  # the span and the request
