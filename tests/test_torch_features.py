"""The port's §V-B feature layer and studies against the reference's, on the
CPU: ``repro_torch.core.features`` against ``repro.core.features``, the
Mandelbrot kernels' plain routes against ``repro.bench.level2.mandelbrot``,
and each ``repro_torch.benchmarks.feat_*`` study against the reference's
``benchmarks/feat_*.py`` (its row names and derived keys).

Inputs come from a numpy seed or the reference's own ``make_inputs`` and go
to both packages as numpy arrays. On the CPU the features run their plain
forms (calls in order, stagers returning CPU tensors); their CUDA forms
(streams, managed memory, device-side launch) run in
``tests/test_torch_cuda.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.feat_coop_groups as ref_cg
import benchmarks.feat_dynamic_parallelism as ref_dp
import benchmarks.feat_hyperq as ref_hq
import benchmarks.feat_unified_memory as ref_um
from repro.bench.level1 import bfs as ref_bfs
from repro.bench.level1.pathfinder import pathfinder_min_path as ref_min_path
from repro.core import features as ref_features
from repro.core.registry import get_benchmark as ref_get_benchmark
from repro_torch.bench.level1.bfs import bfs_depths, make_random_graph
from repro_torch.bench.level1.pathfinder import min_path_steps
from repro_torch.bench.level2.mandelbrot import escape_time, mariani_silver, pixel_grid
from repro_torch.benchmarks import (
    common,
    feat_coop_groups,
    feat_dynamic_parallelism,
    feat_hyperq,
    feat_unified_memory,
)
from repro_torch.core import features
from repro_torch.core.graphs import GraphCache
from repro_torch.kernels import mandelbrot

ROOT = Path(__file__).resolve().parents[1]


# -- core.features ----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 4, 7])
def test_concurrent_pathfinder_equals_a_loop_and_the_reference(n):
    grids = np.random.default_rng(n).integers(0, 10, (n, 16, 64), dtype=np.int32)
    got = features.concurrent_instances(min_path_steps, n)(torch.from_numpy(grids))
    loop = torch.stack([min_path_steps(torch.from_numpy(g)) for g in grids])
    want = jax.jit(ref_features.concurrent_instances(ref_min_path, n))(jnp.asarray(grids))
    assert torch.equal(got, loop)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="leading axis"):
        features.concurrent_instances(min_path_steps, n + 1)(torch.from_numpy(grids))


def test_async_launch_equals_the_reference_in_order():
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(8).astype(np.float32) for _ in range(5)]
    got = features.async_launch(lambda x, s: x * s + 1, [(torch.from_numpy(x), 2.0) for x in xs])
    want = ref_features.async_launch(jax.jit(lambda x, s: x * s + 1),
                                     [(jnp.asarray(x), 2.0) for x in xs])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert features.async_launch(lambda: 3, [(), ()]) == [3, 3]


def test_adaptive_refine_equals_the_reference():
    x = np.random.default_rng(1).standard_normal(64).astype(np.float32) * 3
    run = features.adaptive_refine(torch.round, lambda v: v * 10, lambda c: c > 0)
    ref = ref_features.adaptive_refine(jnp.round, lambda v: v * 10, lambda c: c > 0)
    np.testing.assert_array_equal(run(torch.from_numpy(x)).numpy(), np.asarray(ref(jnp.asarray(x))))
    np.testing.assert_array_equal(
        run(torch.tensor([-1.0, 2.0])).numpy(), np.array([-1.0, 20.0], np.float32))


@pytest.mark.parametrize("preset", [0, 1])
def test_stagers_give_the_references_bfs_depths(preset):
    size = ref_get_benchmark("bfs").presets[preset]
    n, e = size["n_nodes"], size["n_edges"]
    src, dst = make_random_graph(n, e, seed=preset)
    want = np.asarray(ref_bfs.bfs_depths(n, jnp.asarray(src), jnp.asarray(dst), 0))
    stager = features.DemandStager("cpu")
    s, d = stager.get(src), stager.get(dst)
    assert stager.get(src) is s  # staged once per array
    stager.evict()  # nothing to move on the CPU
    np.testing.assert_array_equal(bfs_depths(n, s, d, 0).numpy(), want)
    pf = features.Prefetcher("cpu")
    pf.prefetch("g", (src, dst))
    s2, d2 = pf.get("g")
    np.testing.assert_array_equal(bfs_depths(n, s2, d2, 0).numpy(), want)
    pf.prefetch("one", src)
    assert torch.equal(pf.get("one"), torch.from_numpy(src))
    with pytest.raises(KeyError):
        pf.get("one")  # a get pops the prefetch, as the reference's


# -- Mandelbrot: the kernels' plain routes against the reference ------------


def test_mariani_silver_equals_the_reference_at_preset_0():
    # As tests/test_torch_levels.py: the reference's inputs, its jitted
    # function (XLA:CPU's FMAs part a few pixels above preset 0, queue 3).
    rwl = ref_get_benchmark("mandelbrot_ms").build_preset(0)
    size = ref_get_benchmark("mandelbrot_ms").presets[0]
    n, max_iter = size["n"], size["max_iter"]
    (c,) = rwl.make_inputs(0)
    want = np.asarray(jax.jit(rwl.fn)(c))
    c = torch.from_numpy(np.array(c, np.complex64))
    np.testing.assert_array_equal(mariani_silver(c, max_iter).numpy(), want)
    before = mandelbrot.plain_calls
    routed = mandelbrot.mandelbrot_dp_kernel(c, max_iter)
    flat = mandelbrot.mandelbrot_flat_kernel(c, max_iter)
    assert mandelbrot.plain_calls == before + 2
    np.testing.assert_array_equal(routed.numpy(), want)
    np.testing.assert_array_equal(flat.numpy(), want)


@pytest.mark.parametrize("n,max_iter,mixed", [(128, 256, 16), (256, 256, 60), (512, 256, 226)])
def test_mixed_tiles_follow_the_border_classification(n, max_iter, mixed):
    c = pixel_grid(n)
    assert mandelbrot.mixed_tiles_plain(c, max_iter) == mixed
    if n == 256:
        assert torch.equal(mariani_silver(c, max_iter), escape_time(c, max_iter))


def test_mandelbrot_cuda_entries_refuse_cpu_and_bad_layouts():
    c = pixel_grid(64)
    with pytest.raises(ValueError, match="CUDA"):
        mandelbrot.mandelbrot_flat_cuda(c, 16)
    with pytest.raises(ValueError, match="CUDA"):
        mandelbrot.mandelbrot_dp_cuda(c, 16)


# -- the feature studies against the reference's scripts --------------------


def _keys(rows):
    return [(name, list(common.parse_derived(derived))) for name, _, derived in rows]


def _same_rows(ours, theirs, extra):
    assert [n for n, _ in _keys(ours)] == [n for n, _ in _keys(theirs)]
    for (_, got), (_, want) in zip(_keys(ours), _keys(theirs)):
        assert got == want + extra
    assert all(us > 0 for _, us, _ in ours)


def test_feat_hyperq_rows_match_the_reference():
    graphs = GraphCache(capacity=64)
    ours = feat_hyperq.rows(4, 8, device="cpu", graphs=graphs)
    _same_rows(ours, ref_hq.rows(4, 8), ["streams_us", "max_connections"])
    want = os.environ.get("CUDA_DEVICE_MAX_CONNECTIONS", "8")
    assert all(common.parse_derived(d)["max_connections"] == want for _, _, d in ours)
    assert len(graphs) == 0  # CPU tensors are called plainly, never captured


def test_feat_unified_memory_rows_match_the_reference():
    ours = feat_unified_memory.rows(device="cpu")
    _same_rows(ours, ref_um.rows(), ["concurrent_managed_access"])


def test_feat_coop_groups_rows_match_the_reference():
    _same_rows(feat_coop_groups.rows(device="cpu"), ref_cg.rows(), [])


def test_feat_dynamic_parallelism_rows_match_the_reference():
    ours = feat_dynamic_parallelism.rows(4, device="cpu")
    _same_rows(ours, ref_dp.rows(4), ["mixed_tiles"])
    assert [common.parse_derived(d)["mixed_tiles"] for _, _, d in ours] == [
        str(mandelbrot.mixed_tiles_plain(pixel_grid(n), 4)) for n in feat_dynamic_parallelism.SIZES]


# -- run.py ------------------------------------------------------------------


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run", *args], env=env,
                          capture_output=True, text=True, timeout=300, cwd=str(ROOT))


def test_run_exits_2_on_an_unknown_section():
    out = _run("--sections", "feat_hyperq", "bogus")
    assert out.returncode == 2
    assert "bogus" in out.stderr and "feat_dynamic_parallelism" in out.stderr
    assert "name,us_per_call" not in out.stdout  # nothing ran


def test_run_without_a_card_exits_2_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    out = _run("--sections", "feat_coop_groups")
    assert out.returncode == 2 and "cuda" in out.stderr.lower()
    out = _run("--sections", "feat_coop_groups", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [line.split(",")[0] for line in lines[1:]] == [
        f"feat_cg.srad.{n}x{n}" for n in feat_coop_groups.SIZES]
