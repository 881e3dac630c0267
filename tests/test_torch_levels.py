"""Altis levels 0-2 without a kernel (17 benchmarks) against the reference.

The reference's Workload at preset 0 makes the inputs, and the same values
(``np.asarray`` → ``torch.from_numpy``) go through the reference's ``fn``
and the port's, on the CPU. Tolerances, per benchmark:

- exact: BFS depths, Pathfinder distances, the NW score, Mandelbrot counts
  (integer results; Mandelbrot's iteration is f32, and at preset 0 every
  pixel agrees);
- DeviceMemory reduce: within 1e-6·Σ|x|;
- LavaMD: the reference's own ``rtol=1e-4, atol=1e-5`` (``lavamd.py:106``);
- KMeans: centers and inertia to 1e-5, and every point's nearest center
  the same under both packages' final centers;
- GUPS: every table row to 1e-5;
- the other f32 results (stream, vmem, CFD, DWT2D): 1e-5 relative to the
  output's largest magnitude. vmem's 64 steps t·0.999 + 0.001 round twice
  a step here, once where XLA fuses them, so an element near zero differs
  by more than 1e-5 of itself.

ParticleFilter draws its own numbers on each side: it is held by the
reference's ``validate`` condition and by statistics. The bus-speed rows
run through the engine, whose ``no_jit`` path is checked here too.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.bench.level1 import bfs as ref_bfs
from repro.bench.level2 import nw as ref_nw
from repro.bench.level2 import particlefilter as ref_pf
from repro.core.registry import get_benchmark as ref_benchmark
from repro.core.results import load_run as ref_load_run
from repro_torch.bench.level1 import bfs, gups
from repro_torch.bench.level2 import lavamd, mandelbrot, nw, particlefilter
from repro_torch.core import graphs, harness, suite
from repro_torch.core.engine import Engine
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.registry import BenchmarkSpec, Workload, get_benchmark
from repro_torch.core.results import load_run

LEVELS = (
    "devicemem_stream", "devicemem_reduce", "devicemem_vmem", "busspeeddownload",
    "busspeedreadback", "bfs", "gups", "pathfinder", "cfd", "dwt2d_53", "dwt2d_97",
    "kmeans", "lavamd", "mandelbrot_flat", "mandelbrot_ms", "nw", "particlefilter",
)
HOSTBUS = ("busspeeddownload", "busspeedreadback")
# The deterministic rows, held against the reference's outputs.
PARITY = tuple(n for n in LEVELS if n not in HOSTBUS + ("particlefilter",))
EXACT = ("bfs", "pathfinder", "nw", "mandelbrot_flat", "mandelbrot_ms")
FAST = dict(preset=0, iters=2, warmup=1, device="cpu")


def _reference(name, preset=0, seed=0):
    """The reference's inputs (as made) and its output (numpy)."""
    rwl = ref_benchmark(name).build_preset(preset)
    rargs = rwl.make_inputs(seed)
    return rargs, jax.tree.map(np.asarray, jax.jit(rwl.fn)(*rargs))


def _port(name, rargs, preset=0):
    wl = get_benchmark(name).build_preset(preset)
    args = tuple(torch.from_numpy(np.array(a)) for a in rargs)  # a writable copy
    return wl, args, wl.fn(*args)


def _scaled_close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("name", PARITY)
def test_forward_matches_reference_on_the_same_inputs(name):
    raw, want = _reference(name)
    rargs = [np.asarray(a) for a in raw]
    wl, args, got = _port(name, rargs)
    if name in EXACT:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    elif name == "devicemem_reduce":
        assert abs(float(got) - float(want)) <= 1e-6 * np.abs(rargs[0]).sum()
    elif name == "lavamd":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    elif name == "kmeans":
        (centers, history), (want_centers, want_history) = got, want
        np.testing.assert_allclose(centers.numpy(), want_centers, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(history.numpy(), want_history, rtol=1e-5)
        points = rargs[0].astype(np.float64)

        def nearest(c):
            return np.argmin(((points[:, None] - np.asarray(c, np.float64)[None]) ** 2).sum(-1), 1)

        np.testing.assert_array_equal(nearest(centers.numpy()), nearest(want_centers))
    elif name == "gups":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        _scaled_close(got, want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        assert tuple(g.shape) == np.shape(w) and str(g.dtype).removeprefix("torch.") == str(
            np.asarray(w).dtype)
    if wl.validate is not None:
        wl.validate(got, args)


@pytest.mark.parametrize("name", LEVELS)
def test_each_row_passes_its_validate_on_its_own_inputs(name):
    wl = get_benchmark(name).build_preset(0)
    args = wl.make_inputs(0)
    out = wl.fn(*args)
    assert wl.validate is not None
    wl.validate(out, args)


def _nudge(name, out):
    """A wrong output of the same shape for each row."""
    if name == "kmeans":
        return out[0], out[1].flip(0)  # inertia rising
    if name == "busspeedreadback":
        return out + 1
    out = out.clone(memory_format=torch.contiguous_format)
    flat = out.view(-1)
    flat[flat.numel() // 2] += 1
    return out


@pytest.mark.parametrize("name", ("busspeeddownload", "busspeedreadback", "bfs", "gups",
                                  "pathfinder", "dwt2d_97", "kmeans", "lavamd",
                                  "mandelbrot_flat", "mandelbrot_ms", "nw"))
def test_validate_rejects_a_wrong_output(name):
    wl = get_benchmark(name).build_preset(0)
    args = wl.make_inputs(0)
    out = wl.fn(*args)
    with pytest.raises(AssertionError):
        wl.validate(_nudge(name, out), args)


def test_gups_validate_catches_a_result_short_of_the_updates():
    # The reference's check has no abs(): a table missing updates (a
    # negative difference) passes there and fails here.
    wl = get_benchmark("gups").build_preset(0)
    table, idx, vals = wl.make_inputs(0)
    positive = vals.abs()
    out = gups.gups_update(table, idx, positive)
    short = out - 0.5  # every row, 0.5 below its sum
    assert float(short.sum() - table.sum() - positive.sum()) < 1e-1  # the reference passes it
    with pytest.raises(AssertionError):
        gups.check_updates(short, table, idx, positive)
    gups.check_updates(out, table, idx, positive)


@pytest.mark.parametrize("preset", [0, 1])
@pytest.mark.parametrize("name", ["mandelbrot_flat", "mandelbrot_ms"])
def test_mandelbrot_port_flat_and_adaptive_agree(name, preset):
    wl = get_benchmark(name).build_preset(preset)
    (c,) = wl.make_inputs(0)
    size = get_benchmark(name).presets[preset]
    flat = mandelbrot.escape_time(c, size["max_iter"])
    assert torch.equal(wl.fn(c), flat)
    assert int(flat.max()) == size["max_iter"] and int(flat.min()) >= 1


@pytest.mark.parametrize("check_every", [1, 5, 64])
def test_mandelbrot_counts_do_not_depend_on_how_often_the_host_checks(monkeypatch, check_every):
    # 1 is the reference's check every step, 64 (= max_iter) a fixed loop.
    (c,) = get_benchmark("mandelbrot_flat").build_preset(0).make_inputs(0)
    outside = c[:8, :8] + 3.0  # every pixel escapes within a few steps
    want = mandelbrot.escape_time(c, 64), mandelbrot.escape_time(outside, 64)
    monkeypatch.setattr(mandelbrot, "CHECK_EVERY", check_every)
    assert torch.equal(mandelbrot.escape_time(c, 64), want[0])
    assert torch.equal(mandelbrot.escape_time(outside, 64), want[1])


@pytest.mark.parametrize("preset", [0, 1])
def test_bfs_csr_oracle_equals_the_references_python_oracle(preset):
    size = get_benchmark("bfs").presets[preset]
    src, dst = ref_bfs.make_random_graph(size["n_nodes"], size["n_edges"], 3)
    want = ref_bfs.bfs_host_reference(size["n_nodes"], src, dst, 0)
    np.testing.assert_array_equal(bfs.bfs_host_reference(size["n_nodes"], src, dst, 0), want)
    got = bfs.bfs_depths(size["n_nodes"], torch.from_numpy(src), torch.from_numpy(dst), 0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bfs_marks_a_node_reached_by_any_active_edge():
    # Node 2 is the target of an active edge (0 -> 2) and, later in the
    # edge list, of an inactive one (3 -> 2): a last-write-wins scatter of
    # the active flags would miss it.
    src = torch.tensor([0, 3, 0, 2], dtype=torch.int32)
    dst = torch.tensor([2, 2, 1, 4], dtype=torch.int32)
    got = bfs.bfs_depths(6, src, dst, 0)
    assert got.tolist() == [0, 1, 1, bfs.UNREACHED, 2, bfs.UNREACHED]
    want = ref_bfs.bfs_host_reference(6, src.numpy(), dst.numpy(), 0)
    np.testing.assert_array_equal(bfs.bfs_host_reference(6, src.numpy(), dst.numpy(), 0), want)


@pytest.mark.parametrize("n,m,seed", [(1, 1, 0), (7, 7, 1), (5, 9, 2), (128, 128, 3),
                                      (200, 130, 4)])
def test_nw_row_dp_equals_the_references_oracle(n, m, seed):
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 4, n), rng.integers(0, 4, m)
    assert nw.host_score(a, b) == ref_nw.nw_oracle(a, b)
    if n == m:
        assert int(nw.nw_score(torch.from_numpy(a), torch.from_numpy(b))) == ref_nw.nw_oracle(a, b)


def test_lavamd_chunks_give_the_whole_batchs_sums(monkeypatch):
    wl = get_benchmark("lavamd").build_preset(0)
    args = wl.make_inputs(0)
    whole = wl.fn(*args)
    per_box = 16 * 27 * 16 * 4
    monkeypatch.setattr(lavamd, "CHUNK_BYTES", 5 * per_box)  # 13 chunks of 64 boxes
    torch.testing.assert_close(wl.fn(*args), whole, rtol=1e-6, atol=0)


def test_lavamd_sampled_check_above_the_oracles_size_limit():
    wl = get_benchmark("lavamd").build_preset(1)  # nb 6, ppb 24: 5184 particles
    args = wl.make_inputs(0)
    out = wl.fn(*args)
    wl.validate(out, args)
    pos, charge = (a.numpy() for a in args)
    rows = np.random.default_rng(0).choice(out.numel(), lavamd.SAMPLE, replace=False)
    np.testing.assert_allclose(lavamd.brute_force_oracle(pos, charge, 1.0, rows),
                               lavamd.brute_force_oracle(pos, charge, 1.0)[rows], rtol=1e-6)


def test_particlefilter_meets_the_references_validate_and_statistics():
    steps = get_benchmark("particlefilter").presets[0]["steps"]
    errs = {"port": [], "reference": []}
    for seed in range(3):
        raw, want = _reference("particlefilter", seed=seed)
        meas = np.asarray(raw[0])
        truth, _ = ref_pf.make_trajectory(steps, seed)
        wl = get_benchmark("particlefilter").build_preset(0)
        got = wl.fn(torch.from_numpy(np.array(meas)), seed)
        assert got.shape == want.shape and got.dtype == torch.float32
        # The reference's validate condition, on the port's track.
        assert particlefilter.track_error(got.numpy(), meas) < 3 * ref_pf.MEAS_STD
        # Both tracks follow the truth alike: within a measurement's noise
        # of each other at every step.
        assert np.abs(got.numpy() - want).max() < ref_pf.MEAS_STD
        errs["port"].append(np.abs(got.numpy()[3:] - np.asarray(truth)[3:]).mean())
        errs["reference"].append(np.abs(want[3:] - np.asarray(truth)[3:]).mean())
    assert abs(np.mean(errs["port"]) - np.mean(errs["reference"])) < 0.2 * ref_pf.MEAS_STD


def test_particlefilter_same_seed_same_track():
    wl = get_benchmark("particlefilter").build_preset(0)
    meas, seed = wl.make_inputs(0)
    first, again = wl.fn(meas, seed), wl.fn(meas, seed)
    assert torch.equal(first, again)
    assert not torch.equal(first, wl.fn(meas, seed + 1))


# ---------------------------------------------------------------- the engine


def _plan(**kw):
    return ExecutionPlan(**{**FAST, **kw})


def _no_jit_spec(kernel=None, device_args=()):
    def build():
        return Workload(
            name="zz_no_jit", fn=lambda host, dev: dev.copy_(host),
            make_inputs=lambda seed: (torch.ones(4), torch.zeros(4)),
            bytes_moved=16.0, kernel=kernel,
            meta={"no_jit": True, "device_args": device_args},
        )

    return BenchmarkSpec(name="zz_no_jit", level=0, dwarf=None, domain=None,
                         cuda_feature=None, gpu_feature=None, presets={0: {}}, build=build)


@pytest.mark.parametrize("kernel", [None, "matmul"])
def test_no_jit_falls_back_before_no_kernel(kernel):
    wl = _no_jit_spec(kernel).build_preset(0)
    engine = Engine()
    assert engine._resolve_impl(wl, _plan(impl="kernel"), False) == ("torch", "no_jit")
    assert engine._resolve_impl(wl, _plan(impl="torch"), False) == ("torch", None)
    plain = dataclasses.replace(wl, meta={})
    assert engine._resolve_impl(plain, _plan(impl="kernel"), False) == (
        ("torch", "no_kernel") if kernel is None else ("kernel", None))


def test_no_jit_place_commits_only_the_named_inputs(monkeypatch):
    committed = []
    real = harness.commit_args

    def spy(args, device):
        committed.extend(args)
        return real(args, device)

    monkeypatch.setattr("repro_torch.core.engine.commit_args", spy)
    engine = Engine()
    wl = _no_jit_spec(device_args=(1,)).build_preset(0)
    host, dev = wl.make_inputs(0)
    placed = engine._stage_place(wl, (host, dev), _plan())
    assert placed[0] is host and len(committed) == 1 and committed[0] is dev
    committed.clear()
    plain = dataclasses.replace(wl, meta={})
    engine._stage_place(plain, (host, dev), _plan())
    assert [a is b for a, b in zip(committed, (host, dev), strict=True)] == [True, True]


def test_no_jit_rows_have_no_windowed_columns_and_no_roofline():
    (rec,) = Engine().run(_plan(specs=(_no_jit_spec(device_args=(1,)),), impl="kernel",
                                timing_window=4)).records
    assert rec.status == "ok", rec.error
    assert (rec.impl, rec.impl_fallback, rec.impl_interpret) == ("torch", "no_jit", None)
    assert rec.us_per_call > 0 and rec.achieved_gbps > 0
    assert (rec.us_per_call_windowed, rec.timing_window, rec.timer_dispatch_us) == (None,) * 3
    assert (rec.compute_util10, rec.memory_util10) == (0, 0)
    assert rec.derived.startswith("flops=0.000e+00;bytes=0.000e+00")
    info = harness.empty_compiled_info("x")
    assert info.roofline.bound_s == 0 and info.roofline.hbm_bytes == 0


def test_hostbus_rows_through_the_engine_on_the_cpu(tmp_path):
    path = str(tmp_path / "bus.jsonl")
    rc = suite.main(["--names", *HOSTBUS, "--preset", "0", "--iters", "2", "--warmup", "1",
                     "--impl", "kernel", "--device", "cpu", "--jsonl", path])
    assert rc == 0
    _, records = load_run(path)
    assert [r.name for r in records] == ["busspeeddownload.n1024", "busspeedreadback.n1024"]
    for r in records:
        assert r.status == "ok", r.error
        assert (r.impl, r.impl_fallback, r.impl_interpret) == ("torch", "no_jit", None)
        assert r.us_per_call_windowed is None and r.memory_util10 == 0
        assert r.achieved_gbps > 0
    _, ref_records = ref_load_run(path)
    assert [r.impl_fallback for r in ref_records] == ["no_jit", "no_jit"]


def test_levels_kernel_run_on_cpu_end_to_end(tmp_path):
    """All 17 rows through the suite with ``--impl kernel``: each validates
    and times torch, saying why (``no_jit`` for the bus rows)."""
    path = str(tmp_path / "levels.jsonl")
    rc = suite.main(["--names", *LEVELS, "--preset", "0", "--iters", "1", "--warmup", "0",
                     "--impl", "kernel", "--device", "cpu", "--jsonl", path])
    assert rc == 0
    _, records = load_run(path)
    assert len(records) == len(LEVELS)
    for r in records:
        assert r.status == "ok", r.error
        want = "no_jit" if r.name.startswith("busspeed") else "no_kernel"
        assert (r.impl, r.impl_fallback) == ("torch", want)


def test_graph_cache_run_calls_plainly_on_the_cpu_and_keys_on_layout_and_values():
    cache = graphs.GraphCache()
    x = torch.arange(6)
    assert torch.equal(cache.run(torch.add, x, 1), x + 1) and len(cache) == 0
    key = graphs.args_key(torch.add, (x, 1))
    assert key == graphs.args_key(torch.add, (x, 1))
    others = [graphs.args_key(torch.add, (x.clone(), 1)),
              graphs.args_key(torch.add, (x.view(2, 3), 1)),
              graphs.args_key(torch.add, (x, 2)),
              graphs.args_key(torch.sub, (x, 1))]
    assert all(k != key for k in others) and len(set(others)) == len(others)
