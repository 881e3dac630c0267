"""SRAD's routing between its redesigned kernels (``srad_fused_f32``, the
band kernel; ``srad_phase1_f32``, the float4 row walk) and the kernels they
replaced (``srad_fused_f32_gridstride``, ``srad_phase1_f32_scalar``), the
graph cache that runs the step loop as one CUDA graph, and the loop's
agreement with the reference, on the CPU.

Routing is pure Python over dtype, shapes, the address and the card's SM
count and shared memory (passed in, so large shapes run here as meta
tensors, whose address is 0). The graph cache's keys and launch-count
bookkeeping run with a stand-in graph object. The kernels themselves, and
the graphed loop against the eager one, are held against their plain
versions in ``tests/test_torch_cuda.py`` (on a card).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench.level2 import srad as jsrad
from repro.kernels import ops as jops
from repro_torch.bench.level2 import srad as tsrad_bench
from repro_torch.core.graphs import GraphCache
from repro_torch.core.registry import get_benchmark
from repro_torch.kernels import ops
from repro_torch.kernels import srad_stencil as tsrad

H100 = (132, 232448)  # SMs, shared memory a CTA may opt in to


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def _off(n_before: int, *shape):
    """A contiguous f32 tensor ``n_before`` elements into its storage."""
    numel = int(np.prod(shape))
    base = torch.empty(n_before + numel)
    assert base.data_ptr() % 16 == 0
    return base[n_before:].view(*shape)


# ------------------------------------------------------------------ routing

def _preset_shapes():
    presets = get_benchmark("srad").presets
    return {f"preset{i}": (presets[i]["n"], presets[i]["n"]) for i in range(5)}


FUSED_ROUTES = {
    **{name: (shape, "srad_fused_f32") for name, shape in _preset_shapes().items()},
    "1000x1030": ((1000, 1030), "srad_fused_f32"),
    "8x8": ((8, 8), "srad_fused_f32"),
    "65x33": ((65, 33), "srad_fused_f32"),
    "h1": ((1, 1024), "srad_fused_f32"),
    "w1": ((1024, 1), "srad_fused_f32"),
    "1x1": ((1, 1), "srad_fused_f32"),
    "1800x1800": ((1800, 1800), "srad_fused_f32"),  # about the largest square band
    "2048x2048": ((2048, 2048), "srad_fused_f32_gridstride"),
    "4096x4096": ((4096, 4096), "srad_fused_f32_gridstride"),
    "one_wide_row": ((1, 60000), "srad_fused_f32_gridstride"),
}


@pytest.mark.parametrize("case", sorted(FUSED_ROUTES))
def test_fused_route_takes_the_band_kernel_where_a_band_fits(case):
    shape, want = FUSED_ROUTES[case]
    assert tsrad._route(_meta(*shape), limits=H100) == want
    fits = tsrad.band_smem_bytes(*shape, H100[0]) <= H100[1]
    assert fits == (want == "srad_fused_f32")


def test_preset_shapes_are_the_suites():
    assert list(_preset_shapes().values()) == [(64, 64), (128, 128), (256, 256), (512, 512),
                                               (1024, 1024)]


@pytest.mark.parametrize("h,sms,want", [
    (1024, 132, (128, 8)), (1000, 132, (125, 8)), (1001, 132, (126, 8)),
    (64, 132, (64, 1)), (1, 132, (1, 1)), (133, 132, (67, 2)), (2048, 132, (128, 16)),
    (1024, 114, (114, 9)),
])
def test_bands_cover_the_image_with_at_most_one_cta_an_sm(h, sms, want):
    count, rows = tsrad.bands(h, sms)
    assert (count, rows) == want
    assert count <= sms and (count - 1) * rows < h <= count * rows


def test_band_smem_matches_the_kernels_layout():
    # 1024^2 at 132 SMs: bands of 8 rows; 8 + 2 image rows and 8 + 1 rows of
    # c, 1024 floats each.
    assert tsrad.band_smem_bytes(1024, 1024, 132) == 19 * 1024 * 4
    # Rows padded to a multiple of 4 floats: 1030 -> 1032.
    assert tsrad.band_smem_bytes(1000, 1030, 132) == 19 * 1032 * 4


PHASE1_ROUTES = {
    "aligned_w4": (lambda: torch.empty(64, 64), "srad_phase1_f32"),
    "preset4": (lambda: _meta(1024, 1024), "srad_phase1_f32"),
    "w_4": (lambda: torch.empty(3, 4), "srad_phase1_f32"),
    "w_odd": (lambda: torch.empty(65, 33), "srad_phase1_f32_scalar"),
    "w_2_mod_4": (lambda: _meta(1000, 1030), "srad_phase1_f32_scalar"),
    "base_off_16": (lambda: _off(1, 16, 16), "srad_phase1_f32_scalar"),
    "base_8_off_16": (lambda: _off(2, 16, 16), "srad_phase1_f32_scalar"),
    "base_16_on": (lambda: _off(4, 16, 16), "srad_phase1_f32"),
    "too_tall": (lambda: _meta(tsrad.MAX_WALK_H + 1, 4), "srad_phase1_f32_scalar"),
}


@pytest.mark.parametrize("case", sorted(PHASE1_ROUTES))
def test_phase1_route_takes_the_walk_on_whole_aligned_quads(case):
    make, want = PHASE1_ROUTES[case]
    assert tsrad._route(make(), fused=False) == want


RAISES = {
    "float64": (lambda: torch.empty(8, 8, dtype=torch.float64), "float32"),
    "bfloat16": (lambda: torch.empty(8, 8, dtype=torch.bfloat16), "float32"),
    "rank1": (lambda: torch.empty(64), r"\(H, W\)"),
    "rank3": (lambda: torch.empty(2, 8, 8), r"\(H, W\)"),
    "transposed": (lambda: torch.empty(8, 12).T, "contiguous"),
    "column_slice": (lambda: torch.empty(8, 12)[:, :8], "contiguous"),
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("case", sorted(RAISES))
def test_route_raises_on_layouts_no_entry_takes(case, fused):
    make, match = RAISES[case]
    with pytest.raises(ValueError, match=match):
        tsrad._route(make(), fused=fused, limits=H100)


def test_fused_route_on_a_cpu_tensor_needs_the_limits_given():
    with pytest.raises(ValueError, match="CUDA device"):
        tsrad._route(torch.empty(8, 8))


def test_launch_of_an_entry_raises_cleanly_on_cpu_tensors():
    img = torch.ones(8, 8)
    for name in (*tsrad.FUSED_ENTRIES, *tsrad.PHASE1_ENTRIES):
        with pytest.raises(ValueError, match="CUDA"):
            tsrad._launch(name, img)


# -------------------------------------------------------------- graph cache

class _FakeGraph:
    """Stands in for a CUDA graph: counts captures and replays."""

    made: list = []

    def __init__(self):
        self.captures = self.replays = 0
        _FakeGraph.made.append(self)

    @contextlib.contextmanager
    def capture(self):
        self.captures += 1
        yield

    def replay(self):
        self.replays += 1


def _fake_loop(counter):
    def loop(x, iters):
        for _ in range(iters):
            counter["step"] += 1
            x = x + 1
        return x
    return loop


@pytest.mark.parametrize("iters", [1, 4])
def test_graph_cache_counts_exactly_the_launches_that_ran(iters):
    _FakeGraph.made = []
    cache = GraphCache(new_graph=_FakeGraph)
    counter = {"step": 0, "other": 5}
    loop = _fake_loop(counter)
    x = torch.zeros(3)
    first = cache(("k",), loop, (x, iters), [counter])
    # The first call ran eagerly (its launches count) and captured (not
    # counted: nothing ran).
    assert torch.equal(first, x + iters)
    assert counter == {"step": iters, "other": 5}
    (graph,) = _FakeGraph.made
    assert (graph.captures, graph.replays) == (1, 0)
    outs = []
    for n in range(1, 4):
        outs.append(cache(("k",), loop, (x, iters), [counter]))
        assert counter == {"step": iters * (1 + n), "other": 5}
        assert graph.replays == n
    assert outs[0] is outs[1] is outs[2]  # the static output, every replay
    assert len(_FakeGraph.made) == 1


def test_graph_cache_captures_anew_per_key_and_evicts_the_oldest():
    _FakeGraph.made = []
    cache = GraphCache(capacity=2, new_graph=_FakeGraph)
    counter = {"step": 0}
    loop = _fake_loop(counter)
    x = torch.zeros(2)
    for key in ("a", "b", "a", "c"):  # "a" used again, so "b" is the oldest
        cache(key, loop, (x, 1), [counter])
    assert len(_FakeGraph.made) == 3
    assert "a" in cache and "c" in cache and "b" not in cache and len(cache) == 2
    assert counter["step"] == 4
    cache("b", loop, (x, 1), [counter])  # evicted: eager and captured again
    assert len(_FakeGraph.made) == 4 and counter["step"] == 5
    cache.clear()
    assert len(cache) == 0
    with pytest.raises(ValueError, match="capacity"):
        GraphCache(capacity=0)


def test_graph_cache_failed_capture_raises_and_restores_the_counters():
    class Refuses(_FakeGraph):
        @contextlib.contextmanager
        def capture(self):
            yield
            raise RuntimeError("operation not permitted when stream is capturing")

    cache = GraphCache(new_graph=Refuses)
    counter = {"step": 0}
    with pytest.raises(RuntimeError, match="capturing"):
        cache("k", _fake_loop(counter), (torch.zeros(1), 3), [counter])
    assert counter == {"step": 3} and "k" not in cache


def test_srad_graph_key_holds_address_layout_parameters_and_route():
    img = torch.ones(8, 8)
    base = tsrad_bench.graph_key(img, 4, 0.5, True)
    assert base == tsrad_bench.graph_key(img, 4, 0.5, True)
    others = [
        tsrad_bench.graph_key(img.clone(), 4, 0.5, True),  # another address
        tsrad_bench.graph_key(img.view(4, 16), 4, 0.5, True),  # another shape
        tsrad_bench.graph_key(img.double(), 4, 0.5, True),
        tsrad_bench.graph_key(img, 3, 0.5, True),
        tsrad_bench.graph_key(img, 4, 0.25, True),
        tsrad_bench.graph_key(img, 4, 0.5, False),
    ]
    with ops.force_impl("kernel", "srad_step"):
        others.append(tsrad_bench.graph_key(img, 4, 0.5, True))  # the route
    assert all(k != base for k in others)
    assert len(set(others)) == len(others)


def test_srad_iterations_on_the_cpu_builds_no_graph():
    tsrad_bench.GRAPHS.clear()
    img = torch.rand(8, 8) + 0.5
    out = tsrad_bench.srad_iterations(img, 4, 0.5, True)
    assert len(tsrad_bench.GRAPHS) == 0
    assert out is not tsrad_bench.srad_iterations(img, 4, 0.5, True)


# ----------------------------------------------------- against the reference

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_srad_iterations_match_the_reference_loop(fused, impl):
    """64^2, 4 steps: the port's loop (its kernel route's plain version, or
    the oracle) against the reference's (its Pallas kernels in interpret
    mode), at the reference's 1e-5/1e-6 (tests/test_kernels_misc.py:52)."""
    rng = np.random.default_rng(7)
    img = np.exp(np.float32(0.1) * rng.standard_normal((64, 64), dtype=np.float32))
    with jops.force_impl("pallas", "srad_step"):
        want = np.asarray(jsrad.srad_iterations(jnp.asarray(img), 4, 0.5, fused))
    plain = tsrad.plain_calls
    with ops.force_impl(impl, "srad_step"):
        got = tsrad_bench.srad_iterations(torch.from_numpy(img), 4, 0.5, fused)
    assert tsrad.plain_calls == plain + (4 if impl == "kernel" else 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
