"""The port's continuous batcher, shape buckets and serve validation against
the reference's, on the CPU.

The batcher's policies run in both packages on the same counting closures
and the same instant schedules (the reference's ``tests/test_batching.py``
drives its own the same way), so every dispatch decision (full width,
budget expiry, end-of-stream flush, padding, the in-flight cap) must agree
exactly: the dispatched (bucket, width) sequence and each batch's
(width, filled, cause). ``ShapeBucket`` labels, ``ServeSpec`` validation and
the suite's mix grammar agree case for case, and a trace saved by one
package replays in the other.
"""

import dataclasses

import pytest

import repro.core.plan as jplan
import repro.core.suite as jsuite
import repro.serve.batcher as jbatcher
import repro.serve.loadgen as jloadgen
import repro_torch.core.plan as tplan
import repro_torch.core.suite as tsuite
import repro_torch.serve.batcher as tbatcher
import repro_torch.serve.loadgen as tloadgen
from repro_torch.core.results import RunMetadata

PACKAGES = {"reference": (jbatcher, jloadgen, jplan), "port": (tbatcher, tloadgen, tplan)}


def _counting_calls(buckets, widths):
    """calls[bucket][width] -> closure recording each dispatch (b, w)."""
    dispatched = []

    def make(b, w):
        return lambda: dispatched.append((b, w))

    return {b: {w: make(b, w) for w in widths} for b in buckets}, dispatched


def _both(run):
    """``run(batcher, loadgen)`` in each package -> {package: result}."""
    return {name: run(b, lg) for name, (b, lg, _) in PACKAGES.items()}


def _decisions(report, dispatched):
    return (
        dispatched,
        [(b.bucket, b.width, b.filled, b.cause) for b in report.batches],
        sorted((c.index, c.bucket) for c in report.completions),
        (report.occupancy, report.padding_waste, report.total_slots),
    )


def _instant(loadgen, reqs):
    return loadgen.Schedule(
        requests=tuple(loadgen.Request(index=i, arrival_s=t, bucket=b) for i, t, b in reqs),
        offered_qps=1000.0,
    )


# (policy, buckets, widths, requests (index, arrival, bucket), kwargs)
POLICIES = {
    "loop_width1": ("serve_mixed_loop", ["a", "b"], [1],
                    [(i, 0.0, "ab"[i % 2]) for i in range(6)], {}),
    "lanes_by_bucket": ("serve_mixed_lanes", ["a", "b"], [1],
                        [(i, 0.0, "ab"[i % 2]) for i in range(8)],
                        {"n_lanes": 2, "concurrency": 4}),
    "dynamic_full_then_flush": ("serve_dynamic", ["a"], [1, 2, 4],
                                [(i, 0.0, "a") for i in range(7)],
                                {"budget_s": 10.0, "concurrency": 32}),
    "dynamic_budget_expiry": ("serve_dynamic", ["a"], [1, 2, 4],
                              [(0, 0.0, "a"), (1, 0.0, "a"), (2, 0.25, "a")],
                              {"budget_s": 0.02, "concurrency": 32}),
    "fixed_batched_pads_flush": ("serve_fixed_batched", ["a"], [4],
                                 [(i, 0.0, "a") for i in range(6)],
                                 {"batch": 4, "concurrency": 32}),
    "dynamic_inflight_cap": ("serve_dynamic", ["a"], [1, 2],
                             [(i, 0.0, "a") for i in range(8)],
                             {"budget_s": 10.0, "concurrency": 2}),
    "dynamic_wider_than_cap": ("serve_dynamic", ["a"], [1, 2, 4],
                               [(i, 0.0, "a") for i in range(8)],
                               {"budget_s": 10.0, "concurrency": 1}),
    "dynamic_two_buckets": ("serve_dynamic", ["a", "b"], [1, 2, 4, 8],
                            [(i, 0.0, "aab"[i % 3]) for i in range(21)],
                            {"budget_s": 10.0, "concurrency": 16}),
    "fixed_two_buckets_cap": ("serve_fixed_batched", ["a", "b"], [3],
                              [(i, 0.0, "ab"[i % 2]) for i in range(11)],
                              {"batch": 3, "concurrency": 4}),
}


@pytest.mark.parametrize("case", sorted(POLICIES))
def test_batcher_policies_make_the_reference_decisions_exactly(case):
    policy, buckets, widths, reqs, kwargs = POLICIES[case]

    def run(batcher, loadgen):
        calls, dispatched = _counting_calls(buckets, widths)
        report = getattr(batcher, policy)(calls, _instant(loadgen, reqs), **kwargs)
        return _decisions(report, dispatched)

    got = _both(run)
    assert got["port"] == got["reference"]
    assert len(got["port"][2]) == len(reqs)  # every request served once


def test_budget_expiry_releases_the_partial_batch_before_the_straggler():
    calls, _ = _counting_calls(["a"], [1, 2, 4])
    sched = _instant(tloadgen, [(0, 0.0, "a"), (1, 0.0, "a"), (2, 0.25, "a")])
    report = tbatcher.serve_dynamic(calls, sched, budget_s=0.02, concurrency=32)
    first = report.batches[0]
    assert (first.width, first.filled, first.cause) == (2, 2, "expired")
    assert first.t_dispatch - report.completions[0].t_submit < 0.15


@pytest.mark.parametrize("dispatch", ["lanes", "loop", "batched", "dynamic"])
@pytest.mark.parametrize("max_batch", [1, 2, 5, 8, 16])
def test_bucket_widths_agree(dispatch, max_batch):
    assert tbatcher.bucket_widths(dispatch, max_batch) == jbatcher.bucket_widths(
        dispatch, max_batch)


def test_unknown_bucket_and_missing_width_raise_the_same_errors():
    for name, (batcher, loadgen, _) in PACKAGES.items():
        calls, _ = _counting_calls(["a"], [1])
        stray = _instant(loadgen, [(0, 0.0, "zz")])
        with pytest.raises(KeyError, match="no compiled executables"):
            batcher.serve_dynamic(calls, stray, budget_s=0.01)
        with pytest.raises(KeyError, match="width=1"):
            batcher.serve_mixed_loop({"a": {}}, _instant(loadgen, [(0, 0.0, "a")]))
        with pytest.raises(ValueError, match="budget_s"):
            batcher.serve_dynamic(calls, stray, budget_s=-1.0)
        with pytest.raises(ValueError, match="batch"):
            batcher.serve_fixed_batched(calls, stray, batch=0)


def test_batch_execution_and_report_accounting_agree():
    for batcher in (jbatcher, tbatcher):
        with pytest.raises(ValueError, match="fill"):
            batcher.BatchExecution(bucket="a", width=2, filled=3, t_dispatch=0.0, t_done=0.0)
    batches = [("a", 4, 3), ("b", 2, 2), ("a", 1, 1)]
    reports = [
        b.BatchReport((), tuple(b.BatchExecution(bucket=k, width=w, filled=f, t_dispatch=0.0,
                                                 t_done=0.0) for k, w, f in batches))
        for b in (jbatcher, tbatcher)
    ]
    for attr in ("total_slots", "filled_slots", "occupancy", "padding_waste", "mean_width"):
        assert getattr(reports[0], attr) == getattr(reports[1], attr)


# -- ShapeBucket, ServeSpec and the CLI, case for case ------------------------

BUCKETS = [
    dict(preset=1),
    dict(preset=0, overrides=(("cols", 64), ("rows", 32))),
    dict(preset=0, overrides=[["cols", 64]]),
    dict(preset=2, weight=0.5, overrides=(("n", 1024),)),
    dict(weight=0.0),
    dict(preset=-1),
    dict(overrides=(("cols",),)),
    dict(overrides=((3, 4),)),
    dict(overrides=(("cols", [1, {}]),)),
]


def _outcome(make):
    try:
        value = make()
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e)
    return "ok", value


@pytest.mark.parametrize("i", range(len(BUCKETS)))
def test_shape_bucket_labels_and_checks_agree(i):
    kw = BUCKETS[i]
    want = _outcome(lambda: jplan.ShapeBucket(**kw))
    got = _outcome(lambda: tplan.ShapeBucket(**kw))
    assert got[0] == want[0]
    if want[0] == "ok":
        assert (got[1].label, got[1].weight, got[1].overrides) == (
            want[1].label, want[1].weight, want[1].overrides)
    else:
        assert got[1] == want[1]


def _mix(plan):
    return (plan.ShapeBucket(preset=0, weight=2.0, overrides=(("cols", 64),)),
            plan.ShapeBucket(preset=0, weight=1.0, overrides=(("cols", 128),)))


SPECS = [
    dict(),
    dict(mode="open", qps=10.0),
    dict(mode="open"),
    dict(mode="bogus"),
    dict(client="bogus"),
    dict(concurrency=0),
    dict(lanes=0),
    dict(duration_s=0.0),
    dict(slo_us=0.0),
    dict(slo_us=500.0, client="threaded"),
    dict(colocate="kmeans"),
    dict(mode="open", qps=10.0, colocate="kmeans"),
    dict(colocate="kmeans", client="threaded"),
    dict(mode="open", qps=10.0, dispatch="bogus"),
    dict(mode="open", qps=10.0, dispatch="dynamic"),
    dict(mode="closed", dispatch="dynamic"),
    dict(mode="open", qps=10.0, dispatch="dynamic", client="threaded"),
    dict(mode="open", qps=10.0, dispatch="dynamic", colocate="kmeans"),
    dict(mode="open", qps=10.0, dispatch="dynamic", batch_budget_us=0.0),
    dict(mode="open", qps=10.0, dispatch="dynamic", max_batch=0),
    dict(mode="open", qps=10.0, trace="/tmp/t.jsonl"),
    dict(mode="open", qps=10.0, mix="MIX"),
    dict(mode="open", qps=10.0, mix=()),
    dict(mode="open", qps=10.0, mix=("p0",)),
    dict(mode="open", qps=10.0, mix="DUP"),
    dict(mode="open", qps=10.0, mix=[{"preset": 0, "weight": 2.0, "overrides": [["cols", 64]]},
                                     {"preset": 0, "weight": 1.0,
                                      "overrides": [["cols", 128]]}]),
    dict(client_procs=-1),
]


def _spec_kwargs(kw, plan):
    kw = dict(kw)
    if kw.get("mix") == "MIX":
        kw["mix"] = _mix(plan)
    elif kw.get("mix") == "DUP":
        kw["mix"] = (plan.ShapeBucket(preset=0), plan.ShapeBucket(preset=0))
    return kw


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_serve_spec_checks_agree_case_for_case(i):
    want = _outcome(lambda: jplan.ServeSpec(**_spec_kwargs(SPECS[i], jplan)))
    got = _outcome(lambda: tplan.ServeSpec(**_spec_kwargs(SPECS[i], tplan)))
    assert got[0] == want[0]
    if want[0] != "ok":
        assert got[1] == want[1]
        return
    w, g = want[1], got[1]
    assert g.is_mixed == w.is_mixed
    assert [b.label for b in g.buckets(2)] == [b.label for b in w.buckets(2)]
    assert {f.name for f in dataclasses.fields(g)} == {f.name for f in dataclasses.fields(w)}
    for f in dataclasses.fields(w):
        if f.name != "mix":
            assert getattr(g, f.name) == getattr(w, f.name), f.name


@pytest.mark.parametrize("kw", [dict(mode="open", qps=10.0, client_procs=2),
                                dict(mode="open", qps=10.0, client_procs=4, lanes=4)])
def test_client_procs_is_refused_naming_the_roadmap_item(kw):
    jplan.ServeSpec(**kw)  # the reference serves it through repro.dist
    with pytest.raises(tplan.PlanError, match="item 15"):
        tplan.ServeSpec(**kw)


def test_serve_spec_round_trips_through_run_metadata_json():
    spec = tplan.ServeSpec(mode="open", qps=10.0, dispatch="dynamic", mix=_mix(tplan),
                           trace="t.jsonl", max_batch=4)
    meta = RunMetadata.capture(device="cpu", serve=spec)
    back = RunMetadata(**dataclasses.asdict(meta))
    assert back.serve == spec and back == meta


@pytest.mark.parametrize("text", ["0@2,0/cols=64@1,1/rows=32/cols=2.5", "4@1,4/n=1024@2",
                                  "3/classes=16384", "", "x@1", "0@zero", "0/cols@1", "0@"])
def test_mix_grammar_agrees(text):
    try:
        want = ("ok", jsuite._parse_mix(text))
    except SystemExit as e:
        want = ("exit", str(e))
    try:
        got = ("ok", tsuite._parse_mix(text))
    except SystemExit as e:
        got = ("exit", str(e))
    assert got[0] == want[0]
    if got[0] == "ok":
        assert [(b.label, b.weight) for b in got[1]] == [(b.label, b.weight) for b in want[1]]
    else:
        assert got[1] == want[1]


@pytest.mark.parametrize("argv,flag", [
    (["--serve-mix", "0@1"], "--serve-mix"),
    (["--serve-dispatch", "dynamic"], "--serve-dispatch"),
    (["--qps", "5"], "--qps"),
    (["--max-batch", "4", "--slo-us", "10"], "--slo-us, --max-batch"),
    (["--serve", "closed", "--serve-dispatch", "dynamic"], "mode='open'"),
    (["--colocate", "kmeans", "--serve-client", "threaded"], "single-threaded"),
])
def test_cli_serve_configuration_errors_exit_2_in_both(argv, flag, capsys):
    """A serve flag without a serve mode, or a spec the checks refuse, is a
    configuration error in both suites (exit 2), caught before anything
    runs."""
    for main in (jsuite.main, lambda a: tsuite.main(a + ["--device", "cpu"])):
        assert main(["--names", "pathfinder", *argv]) == 2
        assert flag in capsys.readouterr().err


def test_cli_client_procs_parses_and_exits_2_naming_item_15(capsys):
    rc = tsuite.main(["--device", "cpu", "--names", "pathfinder", "--serve", "open",
                      "--qps", "100", "--client-procs", "2"])
    assert rc == 2
    assert "item 15" in capsys.readouterr().err


# -- traces ------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_trace_saved_by_one_package_replays_in_the_other(tmp_path, writer):
    w_loadgen = PACKAGES[writer][1]
    r_loadgen = PACKAGES["port" if writer == "reference" else "reference"][1]
    sched = w_loadgen.sample_mix(
        w_loadgen.open_loop_schedule(qps=400.0, duration_s=0.25, seed=3, warmup=4),
        {"p0/cols=64": 2.0, "p0/cols=128": 1.0}, seed=3)
    path = str(tmp_path / "mix.jsonl")
    w_loadgen.save_trace(sched, path)
    back = r_loadgen.load_trace(path)
    assert [(r.index, r.arrival_s, r.warmup, r.bucket) for r in back] == [
        (r.index, r.arrival_s, r.warmup, r.bucket) for r in sched]
    assert (back.offered_qps, back.truncated) == (sched.offered_qps, sched.truncated)
    # The replayed schedule drives the other package's batcher to the same
    # decisions as the writer's.
    got = {}
    for name, (batcher, loadgen, _) in PACKAGES.items():
        calls, dispatched = _counting_calls(["p0/cols=64", "p0/cols=128"], [1, 2, 4])
        instant = loadgen.Schedule(requests=tuple(
            dataclasses.replace(r, arrival_s=0.0) for r in loadgen.load_trace(path)),
            offered_qps=back.offered_qps)
        got[name] = _decisions(batcher.serve_dynamic(calls, instant, budget_s=10.0,
                                                     concurrency=8), dispatched)
    assert got["port"] == got["reference"]
