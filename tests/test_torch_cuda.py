"""The port's CUDA kernels against their plain versions, on a card.

These tests need a CUDA card and nvcc, and skip without them. On a machine
with a card (``--noconftest``: the shared conftest imports JAX, which such a
machine need not have):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.engine import Engine
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels import (
    avgpool,
    bitonic_sort,
    flash_attention,
    lrn,
    matmul,
    prefix_scan,
    softmax,
    srad_stencil,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ops import attention as ops_attention
from repro_torch.kernels.ops import sort_kv, srad_step

pytestmark = pytest.mark.cuda

MATMUL_SHAPES = [(8, 8, 8), (128, 128, 128), (130, 70, 50), (1, 256, 33), (257, 1, 128)]
SOFTMAX_SHAPES = [(1, 8), (33, 257), (64, 64), (7, 1031), (3, 40000)]
# The reference's test shapes (tests/test_kernels_misc.py:29,38), then a
# ragged one: C not a multiple of the 32-channel chunk, S not a multiple of
# the 128-position block, an output count not a multiple of 256.
LRN_SHAPES = [(1, 5, 4, 4), (2, 13, 9, 11), (3, 64, 8, 8), (3, 45, 13, 11)]
AVGPOOL_CASES = [((1, 3, 4, 4), 2), ((2, 5, 8, 12), 2), ((1, 8, 9, 9), 3), ((3, 7, 30, 18), 2)]
# The reference's SRAD shapes (tests/test_kernels_misc.py:46), then one that
# needs more blocks than are resident at once (the fused grid-stride path).
SRAD_SHAPES = [(8, 8), (32, 48), (65, 33), (1000, 1030), (2048, 2048)]
# The band kernel's edges (at 132 SMs): H not a multiple of the band count
# with a last band of one row (1001, 133), H below the SM count (100), one
# row, one column, W % 4 != 0 (1027), the preset-4 image, the largest
# square band that fits (1800: 218 KB of shared memory) and rows of more
# float4s than a CTA has threads (8192).
SRAD_BAND_SHAPES = [(1001, 1024), (133, 256), (100, 64), (1, 1), (1, 1024), (1024, 1),
                    (257, 1027), (1024, 1024), (1800, 1800), (20, 8192)]
SCAN_LENGTHS = [8, 1000, 4096, 5, 2**20 + 3]
SORT_LENGTHS = [1, 2, 1000, 4096, 5000, 2**20 + 3]
U_F32 = 2.0**-24
# The reference's attention cases (tests/test_kernels_attention.py:19-27):
# B, Hq, Hkv, T, S, D, causal, window.
ATTENTION_CASES = [
    (1, 2, 2, 32, 32, 16, False, None),
    (2, 4, 2, 32, 32, 16, True, None),
    (1, 8, 1, 17, 17, 8, True, None),
    (2, 4, 4, 33, 33, 16, True, 9),
    (1, 4, 2, 1, 64, 16, True, None),
    (1, 4, 2, 1, 64, 16, True, 17),
    (2, 2, 2, 16, 48, 8, True, None),
]
# Every compiled head dim, ragged T and S, a window wider than the offset
# (S - T = 32 < 40), a non-causal window, decode against a long cache, and
# the LM serving path's two shapes (granite-3-8b: Hq 32, Hkv 8, D 128).
ATTENTION_MORE = [
    (2, 4, 2, 70, 70, 32, True, None),
    (1, 6, 2, 45, 77, 64, True, None),
    (2, 8, 2, 130, 130, 128, True, None),
    (1, 4, 1, 16, 48, 64, True, 40),
    (1, 4, 4, 40, 40, 32, False, 7),
    (2, 32, 8, 1, 1088, 128, False, None),
    (8, 32, 8, 1024, 1024, 128, True, None),
    (8, 32, 8, 1, 1088, 128, False, None),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tol(dtype) -> float:
    return 1e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nn", "tn"])
def test_matmul_kernel_matches_plain(card, m, k, n, dtype, layout):
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((m, k), dtype=np.float32)
    if layout == "tn":  # a transposed view, as the gemm "tn" specs pass
        a = torch.from_numpy(a_np.T.copy()).to(card, dtype).T
    else:
        a = torch.from_numpy(a_np).to(card, dtype)
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(card, dtype)
    got = matmul.matmul_cuda(a, b)
    torch.cuda.synchronize()
    want = matmul.matmul_plain(a, b)
    assert got.dtype == dtype and got.shape == (m, n)
    tol = _tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("rows,cols", SOFTMAX_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_kernel_matches_plain(card, rows, cols, dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(5 * rng.standard_normal((rows, cols), dtype=np.float32))
    x = x.to(card, dtype)
    got = softmax.softmax_cuda(x)
    torch.cuda.synchronize()
    # Relative only: most outputs of a 5*randn row lie far below any
    # absolute tolerance of the reference's size.
    torch.testing.assert_close(
        got.float(), softmax.softmax_plain(x).float(), rtol=_tol(dtype), atol=1e-30
    )


def _softmax_input(card, dtype, case):
    """The softmax cases the two entries split between them, as (x, entry
    the route must pick): C = 1, C not a multiple of the 16-byte vector, a
    view whose rows start off 16 bytes, C above the register kernel's
    limit, rows of equal values, logits of magnitude 80, and the path's
    preset-0 shape."""
    rng = np.random.default_rng(0)
    base = {torch.float32: "softmax_f32", torch.bfloat16: "softmax_bf16"}[dtype]
    online = base + "_online"
    per16 = 16 // torch.empty((), dtype=dtype).element_size()

    def randn(*shape, scale=5.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).to(
            card, dtype)

    if case == "c_is_1":
        return randn(37, 1), online
    if case == "c_not_whole_vectors":
        return randn(9, 4 * per16 + 3), online
    if case == "misaligned_rows":  # each row starts one element past the last
        return randn(6, 1025)[:, 1:], online
    if case == "above_register_limit":
        return randn(3, softmax.MAX_COLS + 4 * per16), online
    if case == "equal_rows":
        return torch.full((5, 2048), 3.25, device=card, dtype=dtype), base
    if case == "magnitude_80":
        return randn(16, 4096, scale=80.0), base
    if case == "largest_register_row":
        return randn(4, softmax.MAX_COLS), base
    if case == "ragged_vectors":  # the last thread owns fewer vectors
        return randn(7, 1000 * per16), base
    return randn(128, 1024), base  # preset 0


SOFTMAX_ROUTE_CASES = ["c_is_1", "c_not_whole_vectors", "misaligned_rows",
                       "above_register_limit", "equal_rows", "magnitude_80",
                       "largest_register_row", "ragged_vectors", "preset_0"]


@pytest.mark.parametrize("case", SOFTMAX_ROUTE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_entries_match_plain(card, case, dtype):
    x, entry = _softmax_input(card, dtype, case)
    assert softmax._route(x) == entry
    before = dict(softmax.launches)
    got = softmax.softmax_cuda(x)
    torch.cuda.synchronize()
    assert softmax.launches[entry] == before[entry] + 1
    assert sum(softmax.launches.values()) == sum(before.values()) + 1
    torch.testing.assert_close(
        got.float(), softmax.softmax_plain(x).float(), rtol=_tol(dtype), atol=1e-30
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_online_entry_takes_the_register_layouts_too(card, dtype):
    x, entry = _softmax_input(card, dtype, "magnitude_80")
    online = entry + "_online"
    before = softmax.launches[online]
    got = softmax._launch(online, x)
    torch.cuda.synchronize()
    assert softmax.launches[online] == before + 1
    torch.testing.assert_close(
        got.float(), softmax.softmax_plain(x).float(), rtol=_tol(dtype), atol=1e-30
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False])
def test_batched_matmul_kernel_matches_plain(card, dtype, shared):
    rng = np.random.default_rng(0)
    batch, m, k, n = 5, 130, 70, 50
    a = torch.from_numpy(rng.standard_normal((m, k) if shared else (batch, m, k),
                                             dtype=np.float32)).to(card, dtype)
    b = torch.from_numpy(rng.standard_normal((batch, k, n), dtype=np.float32)).to(card, dtype)
    before = dict(matmul.launches)
    got = matmul.matmul_cuda(a, b)
    torch.cuda.synchronize()
    # K = 70 floats is no multiple of 16 bytes: the SIMT kernel's batch.
    key = "matmul_f32_simt_batched" if dtype == torch.float32 else "matmul_bf16_wmma_batched"
    assert matmul._route(a, b) + "_batched" == key
    assert matmul.launches[key] == before[key] + 1
    assert got.shape == (batch, m, n)
    tol = _tol(dtype)
    torch.testing.assert_close(got.float(), matmul.matmul_plain(a, b).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", LRN_SHAPES)
@pytest.mark.parametrize("size", [3, 5, 7])
def test_lrn_kernel_matches_plain(card, shape, size):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape, dtype=np.float32))
    x = x.to(card)
    got = lrn.lrn_cuda(x, size=size)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, lrn.lrn_plain(x, size=size), rtol=1e-5, atol=1e-6)


# (shape, size, the entry the route must pick): the ring's sizes at S % 4
# == 0 with C a multiple of the 32-channel chunk and not, at S % 4 != 0,
# and a size the ring does not compile.
LRN_ROUTE_CASES = [
    ((2, 64, 8, 8), 3, "lrn_f32"), ((2, 64, 8, 8), 5, "lrn_f32"),
    ((3, 45, 8, 8), 3, "lrn_f32"), ((3, 45, 8, 8), 5, "lrn_f32"),
    ((2, 7, 2, 2), 5, "lrn_f32"), ((2, 13, 9, 11), 3, "lrn_f32_smem"),
    ((2, 13, 9, 11), 5, "lrn_f32_smem"), ((3, 45, 8, 8), 7, "lrn_f32_smem"),
    ((8, 32, 16, 16), 5, "lrn_f32"),  # preset 0
]


@pytest.mark.parametrize("shape,size,entry", LRN_ROUTE_CASES)
def test_lrn_entries_match_plain(card, shape, size, entry):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape, dtype=np.float32))
    x = x.to(card)
    assert lrn._route(x, size) == entry
    before = dict(lrn.launches)
    got = lrn.lrn_cuda(x, size=size)
    torch.cuda.synchronize()
    assert lrn.launches[entry] == before[entry] + 1
    assert sum(lrn.launches.values()) == sum(before.values()) + 1
    torch.testing.assert_close(got, lrn.lrn_plain(x, size=size), rtol=1e-5, atol=1e-6)


def test_lrn_smem_entry_takes_the_ring_layouts_too(card):
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((3, 45, 8, 8), dtype=np.float32)).to(card)
    before = lrn.launches["lrn_f32_smem"]
    got = lrn._launch("lrn_f32_smem", x, size=5)
    torch.cuda.synchronize()
    assert lrn.launches["lrn_f32_smem"] == before + 1
    torch.testing.assert_close(got, lrn.lrn_plain(x, size=5), rtol=1e-5, atol=1e-6)


def test_lrn_off_16_bytes_takes_the_smem_entry(card):
    base = torch.randn(1 + 2 * 40 * 16, device=card)
    x = base[1:].view(2, 40, 4, 4)  # contiguous, 4 bytes past 16-byte alignment
    assert lrn._route(x, 5) == "lrn_f32_smem"
    torch.testing.assert_close(lrn.lrn_cuda(x, size=5), lrn.lrn_plain(x, size=5),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,ks", AVGPOOL_CASES)
def test_avgpool_kernel_matches_plain(card, shape, ks):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape, dtype=np.float32))
    x = x.to(card)
    got = avgpool.avgpool_cuda(x, ksize=ks)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, avgpool.avgpool_plain(x, ksize=ks), rtol=1e-6, atol=1e-6)


def test_avgpool_kernel_takes_an_odd_offset_view(card):
    # A contiguous view one float into its storage is not 8-byte aligned:
    # the kernel must not take its float2 path there.
    base = torch.randn(1 + 2 * 3 * 8 * 8, device=card)
    x = base[1:].view(2, 3, 8, 8)
    assert x.data_ptr() % 8 != 0
    torch.testing.assert_close(avgpool.avgpool_cuda(x), avgpool.avgpool_plain(x),
                               rtol=1e-6, atol=1e-6)


def test_new_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.ones(2, 8, 4, 4, device=card)
    with pytest.raises(ValueError, match="odd window size"):
        lrn.lrn_cuda(x, size=4)
    with pytest.raises(ValueError, match="size <= 65"):
        lrn.lrn_cuda(x, size=67)
    with pytest.raises(ValueError, match="float32"):
        lrn.lrn_cuda(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        lrn.lrn_cuda(x.transpose(2, 3))
    with pytest.raises(ValueError, match="divisible by ksize"):
        avgpool.avgpool_cuda(x, ksize=3)
    with pytest.raises(ValueError, match="float32"):
        avgpool.avgpool_cuda(x.half())
    a = torch.ones(3, 4, 4, device=card)
    with pytest.raises(ValueError, match="batches differ"):
        matmul.matmul_cuda(a, torch.ones(2, 4, 4, device=card))
    with pytest.raises(ValueError, match="at most 65535"):
        matmul.matmul_cuda(torch.ones(65536, 1, 1, device=card), torch.ones(1, 1, device=card))


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    a = torch.ones(8, 8, device=card)
    with pytest.raises(ValueError, match="row- or column-major"):
        matmul.matmul_cuda(a[:, ::2].T, a)
    with pytest.raises(ValueError, match="float32 or two bfloat16"):
        matmul.matmul_cuda(a.half(), a.half())
    with pytest.raises(ValueError, match="unit stride"):
        softmax.softmax_cuda(a[:, ::2])


def test_kernel_rows_on_the_card_launch_the_kernels(card):
    before = sum(matmul.launches.values()), sum(softmax.launches.values())
    online = softmax.launches["softmax_f32_online"]  # the preset's rows take registers
    res = Engine().run(ExecutionPlan(
        names=("gemm_bf16_tn", "softmax"), preset=0, iters=2, warmup=1,
        include_backward=False, impl="kernel",
    ))
    assert [r.status for r in res.records] == ["ok", "ok"]
    assert all(r.impl_interpret is False for r in res.records)
    calls = 1 + 1 + 1 + 2 * (1 + 4)
    after = sum(matmul.launches.values()), sum(softmax.launches.values())
    assert (after[0] - before[0], after[1] - before[1]) == (calls, calls)
    assert softmax.launches["softmax_f32_online"] == online


def test_dnn_kernel_rows_on_the_card_launch_the_kernels(card):
    mods = (matmul, lrn, avgpool)
    before = [dict(m.launches) for m in mods]
    res = Engine().run(ExecutionPlan(
        names=("convolution_im2col", "lrn", "pooling"), preset=0, iters=2, warmup=1,
        include_backward=True, impl="kernel",
    ))
    assert [r.status for r in res.records] == ["ok"] * 6
    calls = 1 + 1 + 1 + 2 * (1 + 4)
    deltas = {k: m.launches[k] - b[k] for m, b in zip(mods, before) for k in m.launches}
    # im2col's operands are contiguous: every call on the TMA kernel.
    assert deltas == {
        "matmul_f32": 0, "matmul_f32_batched": calls, "matmul_f32_simt": 0,
        "matmul_f32_simt_batched": 0, "matmul_bf16": 0, "matmul_bf16_batched": 0,
        "matmul_bf16_wmma": 0, "matmul_bf16_wmma_batched": 0, "lrn_f32": calls,
        "lrn_f32_smem": 0,
        "avgpool_f32": calls,
    }


def _srad_image(card, h, w, offset=0):
    rng = np.random.default_rng(h * 7919 + w)
    img = rng.uniform(0.2, 1.0, size=offset + h * w).astype(np.float32)
    return torch.from_numpy(img).to(card)[offset:].view(h, w)


@pytest.mark.parametrize("h,w", SRAD_SHAPES)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_srad_kernel_matches_plain(card, h, w, fused):
    img = _srad_image(card, h, w)
    key = srad_stencil._route(img, fused=fused)
    before = dict(srad_stencil.launches)
    got = srad_stencil.srad_step_cuda(img, fused=fused)
    torch.cuda.synchronize()
    want = {k: int(k == key or (not fused and k == "srad_phase2_f32")) for k in before}
    assert {k: srad_stencil.launches[k] - before[k] for k in before} == want
    # Bit for bit: every entry follows the oracle operation by operation.
    torch.testing.assert_close(got, srad_stencil.srad_step_plain(img), rtol=0, atol=0)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "base_off_16"])
@pytest.mark.parametrize("h,w", SRAD_SHAPES + SRAD_BAND_SHAPES)
def test_srad_every_entry_is_bit_equal_to_plain(card, h, w, offset):
    """Each entry that takes the image, routed or not (the replaced
    kernels take every image), against the plain version to the bit: the
    fused step, phase 1 and phase 2."""
    img = _srad_image(card, h, w, offset)
    step = srad_stencil.srad_step_plain(img)
    c_plain = srad_stencil.srad_phase1_plain(img)
    for fused, want in ((True, step), (False, c_plain)):
        routed = srad_stencil._route(img, fused=fused)
        entries = srad_stencil.FUSED_ENTRIES if fused else srad_stencil.PHASE1_ENTRIES
        for name in dict.fromkeys((routed, entries[1])):
            before = dict(srad_stencil.launches)
            got = srad_stencil._launch(name, img)
            torch.cuda.synchronize()
            assert {k: srad_stencil.launches[k] - before[k] for k in before} == {
                k: int(k == name) for k in before}
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)
    torch.testing.assert_close(srad_stencil.srad_phase2_cuda(img, c_plain),
                               srad_stencil.srad_phase2_plain(img, c_plain), rtol=0, atol=0)


def test_srad_presets_route_to_the_redesigned_entries(card):
    from repro_torch.core.registry import get_benchmark

    presets = get_benchmark("srad").presets
    for n in [presets[i]["n"] for i in range(5)] + [1000]:
        img = torch.ones(n, n + 30 * (n == 1000), device=card)
        assert srad_stencil._route(img) == "srad_fused_f32"
    img = torch.ones(1024, 1024, device=card)
    assert srad_stencil._route(img, fused=False) == "srad_phase1_f32"
    assert srad_stencil._route(torch.ones(4096, 4096, device=card)) == (
        "srad_fused_f32_gridstride")


@pytest.mark.parametrize("mode", ["kernel", "ref"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_srad_graphed_loop_is_bit_equal_to_the_eager_loop(card, fused, mode):
    from repro_torch.bench.level2 import srad as srad_bench
    from repro_torch.kernels import ops

    img = _srad_image(card, 256, 256)
    with ops.force_impl(mode, "srad_step"):
        eager = srad_bench._steps(img, 4, 0.5, fused)
    srad_bench.GRAPHS.clear()
    per_call = ({"srad_fused_f32": 4} if fused else
                {"srad_phase1_f32": 4, "srad_phase2_f32": 4}) if mode == "kernel" else {}
    with ops.force_impl(mode, "srad_step"):
        before = dict(srad_stencil.launches)
        first = srad_bench.srad_iterations(img, 4, 0.5, fused)  # eager, then captured
        torch.cuda.synchronize()
        assert len(srad_bench.GRAPHS) == 1
        mem = torch.cuda.memory_allocated(card)
        for calls in range(2, 5):
            out = srad_bench.srad_iterations(img, 4, 0.5, fused)  # a replay
            torch.cuda.synchronize()
            assert {k: v - before[k] for k, v in srad_stencil.launches.items()} == {
                k: calls * per_call.get(k, 0) for k in before}
            assert torch.equal(out, eager) and torch.equal(first, eager)
        assert torch.cuda.memory_allocated(card) == mem  # replays allocate nothing
        assert len(srad_bench.GRAPHS) == 1
        # Another address: another capture, of the same result.
        other = srad_bench.srad_iterations(img.clone(), 4, 0.5, fused)
        assert len(srad_bench.GRAPHS) == 2 and torch.equal(other, eager)
        assert torch.equal(srad_bench.srad_iterations(img.clone(), 4, 0.5, fused), eager)
    srad_bench.GRAPHS.clear()


@pytest.mark.parametrize("n", SCAN_LENGTHS)
def test_prefix_scan_kernel_matches_plain(card, n):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n, dtype=np.float32)).to(card)
    got = prefix_scan.prefix_scan_cuda(x)
    torch.cuda.synchronize()
    exact = torch.cumsum(x.double(), 0)
    # Each output is a sum of up to n f32 roundings of partial sums whose
    # rms is at most sqrt(n) * rms(x): 16 * n * u * rms(x) bounds them with
    # room to spare, as the GEMM checks' 16 * K * u * sigma.
    atol = 16 * n * U_F32 * x.double().square().mean().sqrt().item()
    assert (got.double() - exact).abs().max().item() <= atol
    assert (prefix_scan.prefix_scan_plain(x).double() - exact).abs().max().item() <= atol


@pytest.mark.parametrize("n", [2**24 - 1, 2**24])
def test_prefix_scan_of_flags_is_exact(card, n):
    flags = (torch.rand(n, device=card, generator=torch.Generator(card).manual_seed(n))
             < 0.5).float()
    got = prefix_scan.prefix_scan_cuda(flags)
    want = torch.cumsum(flags.long(), 0)
    assert torch.equal(got.long(), want)
    ones = torch.ones(n, device=card)
    assert torch.equal(prefix_scan.prefix_scan_cuda(ones).long(), torch.arange(1, n + 1, device=card))


def _sort_keys(kind: str, n: int, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if kind == "int32_full":  # negatives included
        return torch.randint(-2**31, 2**31, (n,), generator=gen, device=dev, dtype=torch.int64).int()
    if kind == "int32_dups":  # [0, 2^30) drawn from 1000 values
        pool = torch.randint(0, 1 << 30, (1000,), generator=gen, device=dev, dtype=torch.int32)
        return pool[torch.randint(0, 1000, (n,), generator=gen, device=dev)]
    # f32 with negatives, ties, and both zeros
    return torch.round(8 * torch.randn(n, generator=gen, device=dev)) / 8


@pytest.mark.parametrize("n", SORT_LENGTHS)
@pytest.mark.parametrize("kind", ["int32_full", "int32_dups", "float32_ties"])
def test_sort_kernel_equals_the_stable_plain_version(card, n, kind):
    gen = torch.Generator(card).manual_seed(n)
    keys = _sort_keys(kind, n, gen)
    vals = torch.arange(n, dtype=torch.int32, device=card)
    ko, vo = bitonic_sort.sort_kv_cuda(keys, vals)
    torch.cuda.synchronize()
    pk, pv = bitonic_sort.sort_kv_plain(keys, vals)
    # Bit for bit, keys and values: the kernel is stable.
    assert torch.equal(ko.view(torch.int32), pk.view(torch.int32))
    assert torch.equal(vo, pv)


def test_sort_keeps_negative_and_positive_zero_in_input_order(card):
    keys = torch.tensor([0.0, -0.0, 1.0, -0.0, 0.0, -1.0], device=card)
    vals = torch.arange(6, dtype=torch.int32, device=card)
    ko, vo = bitonic_sort.sort_kv_cuda(keys, vals)
    assert vo.tolist() == [5, 0, 1, 3, 4, 2]
    assert torch.equal(ko.view(torch.int32), keys[vo.long()].view(torch.int32))


def test_new_kernel_routes_raise_on_unsupported_dtypes(card):
    """A CUDA tensor of a dtype the kernels do not take raises; it never runs
    the plain version instead."""
    plain = (bitonic_sort.plain_calls, srad_stencil.plain_calls, prefix_scan.plain_calls)
    k64 = torch.arange(8, dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="int32 or float32 keys"):
        sort_kv(k64, torch.arange(8, dtype=torch.int32, device=card), mode="kernel")
    with pytest.raises(ValueError, match="4-byte values"):
        sort_kv(k64.int(), k64, mode="kernel")
    img64 = torch.ones(8, 8, dtype=torch.float64, device=card)
    for fused in (True, False):
        with pytest.raises(ValueError, match="float32"):
            srad_step(img64, fused=fused, mode="kernel")
    with pytest.raises(ValueError, match="float32"):
        prefix_scan.prefix_scan_kernel(torch.ones(8, dtype=torch.float64, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        srad_stencil.srad_step_cuda(torch.ones(8, 8, device=card).T[:, :4])
    assert (bitonic_sort.plain_calls, srad_stencil.plain_calls, prefix_scan.plain_calls) == plain


def test_sort_where_srad_rows_on_the_card_launch_the_kernels(card):
    mods = (bitonic_sort, prefix_scan, srad_stencil)
    before = [dict(m.launches) for m in mods]
    engine = Engine()
    res = engine.run(ExecutionPlan(
        names=("sort", "where", "srad"), preset=0, iters=2, warmup=1, impl="kernel",
    ))
    split = engine.run(ExecutionPlan(
        names=("srad",), preset=0, iters=2, warmup=1, impl="kernel",
        overrides={"srad": {"fused": False}},
    ))
    records = res.records + split.records
    assert [r.status for r in records] == ["ok"] * 4, [r.error for r in records]
    assert all(r.impl_interpret is False for r in records)
    calls = 1 + 1 + 1 + 2 * (1 + 4)
    deltas = {k: m.launches[k] - b[k] for m, b in zip(mods, before) for k in m.launches}
    assert deltas == {
        "sort_kv_i32": calls, "sort_kv_f32": 0, "prefix_scan_f32": calls,
        "srad_fused_f32": 4 * calls, "srad_fused_f32_gridstride": 0,
        "srad_phase1_f32": 4 * calls, "srad_phase1_f32_scalar": 0,
        "srad_phase2_f32": 4 * calls,
    }


def _attention_inputs(card, b, hq, hkv, t, s_len, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(card, dtype)
               for shape in ((b, hq, t, d), (b, hkv, s_len, d), (b, hkv, s_len, d)))
    return q, k, v


def _attention_tol(dtype) -> float:
    # tests/test_kernels_attention.py:39,48
    return 2e-4 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,window", ATTENTION_CASES + ATTENTION_MORE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(card, b, hq, hkv, t, s, d, causal, window, dtype):
    q, k, v = _attention_inputs(card, b, hq, hkv, t, s, d, dtype)
    key = flash_attention._route(q, k, v, window)
    before = flash_attention.launches[key]
    got = flash_attention.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches[key] == before + 1
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == want.shape
    tol = _attention_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_reads_views_in_place(card, dtype):
    """The model's inputs: (B, T, H, D) activations seen as (B, H, T, D), and
    a (B, S, KV, D) cache sliced to its valid length; and a view one element
    into its storage, which takes the kernel's unaligned loads."""
    b, hq, hkv, t, s_len, kv_len, d = 2, 8, 2, 5, 40, 29, 64
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((b, t, hq, d), dtype=np.float32)).to(card, dtype)
    kc = torch.from_numpy(rng.standard_normal((b, s_len, hkv, d), dtype=np.float32)).to(card, dtype)
    vc = torch.from_numpy(rng.standard_normal((b, s_len, hkv, d), dtype=np.float32)).to(card, dtype)
    qv = q.transpose(1, 2)
    kv_, vv = kc[:, :kv_len].transpose(1, 2), vc[:, :kv_len].transpose(1, 2)
    tol = _attention_tol(dtype)
    for causal in (False, True):
        got = flash_attention.flash_attention_cuda(qv, kv_, vv, causal=causal)
        want = flash_attention.flash_attention_plain(
            qv.contiguous(), kv_.contiguous(), vv.contiguous(), causal=causal)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        # The output is laid out (B, T, H, D): the model reshapes it for free.
        assert got.transpose(1, 2).is_contiguous()
    flat = torch.from_numpy(rng.standard_normal(1 + b * hkv * s_len * d, dtype=np.float32))
    k_odd = flat.to(card, dtype)[1:].view(b, hkv, s_len, d)
    assert k_odd.data_ptr() % 16 != 0
    q2 = qv.contiguous()
    got = flash_attention.flash_attention_cuda(q2, k_odd, k_odd, causal=True)
    want = flash_attention.flash_attention_plain(q2, k_odd, k_odd, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_attention_kernel_refuses_what_it_does_not_take(card):
    q = torch.ones(1, 2, 4, 16, device=card)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_cuda(q[..., :12], q[..., :12], q[..., :12])
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention.flash_attention_cuda(q, torch.ones(1, 2, 4, 32, device=card)[..., ::2], q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention.flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="compiled tile"):
        flash_attention.flash_attention_cuda(q, q, q, block_q=64)
    plain = flash_attention.plain_calls
    with pytest.raises(ValueError, match="head dim"):
        ops_attention(q[..., :12], q[..., :12], q[..., :12], mode="kernel")
    assert flash_attention.plain_calls == plain


# The bf16 GEMM's TMA kernel: the reference's shapes (those TMA can read go
# to it, the rest to the WMMA kernel), the path's 4096^3, and ragged M and N
# that only TMA's zero fill covers.
TMA_MATMUL_SHAPES = MATMUL_SHAPES + [(4096, 4096, 4096), (1000, 1000, 1000), (200, 72, 136)]


@pytest.mark.parametrize("m,k,n", TMA_MATMUL_SHAPES)
@pytest.mark.parametrize("layout", ["nn", "tn"])
def test_bf16_matmul_entries_match_plain(card, m, k, n, layout):
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((m, k), dtype=np.float32)
    if layout == "tn":
        a = torch.from_numpy(a_np.T.copy()).to(card, torch.bfloat16).T
    else:
        a = torch.from_numpy(a_np).to(card, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(card, torch.bfloat16)
    key = matmul._route(a, b)
    if min(m, n) >= 200:
        assert key == "matmul_bf16"
    before = dict(matmul.launches)
    got = matmul.matmul_cuda(a, b)
    torch.cuda.synchronize()
    assert {k_: matmul.launches[k_] - before[k_] for k_ in before} == {
        k_: int(k_ == key) for k_ in before}
    want = matmul.matmul_plain(a, b)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_bf16_matmul_wmma_takes_what_tma_cannot(card):
    """A row stride that is not a multiple of 8, a base off 16 bytes, and a
    column-major B go to the WMMA kernel, and agree with the plain version
    there."""
    bf = torch.bfloat16
    a_ragged = torch.randn(64, 66, device=card).to(bf)[:, :65]  # row stride 66
    b_odd = torch.randn(65 * 72 + 8, device=card).to(bf)[1:1 + 65 * 72].view(65, 72)
    a = torch.randn(64, 72, device=card).to(bf)
    b_col = torch.randn(65, 72, device=card).to(bf).T  # (72, 65), column-major
    for x, y in ((a_ragged, b_odd), (a, b_col)):
        assert matmul._route(x, y) == "matmul_bf16_wmma"
        before = matmul.launches["matmul_bf16_wmma"]
        got = matmul.matmul_cuda(x, y)
        assert matmul.launches["matmul_bf16_wmma"] == before + 1
        torch.testing.assert_close(got.float(), matmul.matmul_plain(x, y).float(),
                                   rtol=2e-2, atol=2e-2)


def _with_head_dim(case, d):
    b, hq, hkv, t, s, _, causal, window = case
    return (b, hq, hkv, t, s, d, causal, window)


# The reference's cases and the ones above at the tensor cores' head dims, so
# that they reach the prefill and decode kernels (or the SIMT kernel, for 17
# to 63 rows per KV head); then groups of 1 and 8, a group that does not
# divide 128 (wgmma, 126 packed rows a CTA), ragged T and S, windows, and
# T < S.
TC_ATTENTION_CASES = sorted({
    _with_head_dim(c, d) for c in ATTENTION_CASES + ATTENTION_MORE for d in (64, 128)
} | {
    (2, 8, 8, 100, 100, 128, True, None), (1, 16, 2, 77, 200, 64, True, None),
    (1, 6, 1, 40, 40, 64, True, None), (2, 4, 1, 300, 300, 128, True, 100),
    (1, 8, 2, 96, 333, 128, False, 150), (1, 4, 1, 1, 5000, 128, True, 700),
    (3, 8, 2, 4, 515, 64, True, 33),
}, key=str)


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,window", TC_ATTENTION_CASES)
def test_bf16_attention_entries_match_plain(card, b, hq, hkv, t, s, d, causal, window):
    q, k, v = _attention_inputs(card, b, hq, hkv, t, s, d, torch.bfloat16)
    key = flash_attention._route(q, k, v, window)
    rows = hq // hkv * t
    if rows <= 16:
        assert key == "flash_decode_bf16"
    elif rows >= 64:
        assert key == "flash_attention_bf16_wgmma"
    before = dict(flash_attention.launches)
    got = flash_attention.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    # One launch, the decode kernel's too (its merge is in its epilogue).
    want_counts = {k_: int(k_ == key) for k_ in before}
    assert {k_: flash_attention.launches[k_] - before[k_] for k_ in before} == want_counts
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


# Decode shapes: the path's, S below one split's tiles, windows that leave
# the first splits without a visible key for some rows, causal T > 1, rows
# that see no key (T > S, causal), and a window that leaves whole splits
# empty for every row.
DECODE_CASES = [
    (8, 32, 8, 1, 1088, 128, False, None), (2, 4, 2, 1, 40, 64, True, None),
    (1, 4, 2, 1, 700, 128, True, 100), (1, 8, 2, 4, 300, 64, True, 9),
    (2, 16, 2, 2, 200, 128, False, 70), (1, 4, 2, 4, 3, 64, True, None),
    (2, 8, 1, 2, 500, 128, True, 5),
]


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,window", DECODE_CASES)
def test_decode_kernel_at_every_split_count(card, b, hq, hkv, t, s, d, causal, window):
    """One launch at 1 split up to more splits than visible tiles: bit-equal
    to flash_decode_combine_plain (the merge arithmetic in torch ops) on the
    kernel's own partials, within 2e-2 of the split plain version and of
    the plain attention, and the stream's counters back at 0."""
    q, k, v = _attention_inputs(card, b, hq, hkv, t, s, d, torch.bfloat16)
    lo, hi = flash_attention.decode_tiles(t, s, hq // hkv, causal, window)
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, window=window).float()
    stream = torch.cuda.current_stream(card).cuda_stream
    for splits in sorted({1, 2, 3, 5, hi - lo, hi - lo + 1, hi - lo + 3} - {0}):
        before = dict(flash_attention.launches)
        got = flash_attention.flash_decode_cuda(q, k, v, causal=causal, window=window,
                                                splits=splits)
        assert {n: flash_attention.launches[n] - before[n] for n in before} == {
            n: int(n == "flash_decode_bf16") for n in before}
        part_o, part_ml = flash_attention.flash_decode_partials_cuda(
            q, k, v, causal=causal, window=window, splits=splits)
        merged = flash_attention.flash_decode_combine_plain(part_o, part_ml, hq=hq, t=t,
                                                            dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(got, merged), f"{splits} splits"
        plain = flash_attention.flash_decode_plain(q, k, v, causal=causal, window=window,
                                                   splits=splits).float()
        torch.testing.assert_close(got.float(), plain, rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
        counters = flash_attention.scratch.counters(card, stream)
        if splits > 1:
            assert not bool(counters.any())


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,window", DECODE_CASES)
def test_decode_kernels_lse_matches_the_plain_lse(card, b, hq, hkv, t, s, d, causal, window):
    """flash_decode_bf16 with ``return_lse`` at 1 split up to more splits
    than visible tiles: each row's log-sum-exp within 1e-4 of
    flash_decode_plain's (-inf where a row sees no key), its output
    bit-equal to the same call without it, one launch either way."""
    q, k, v = _attention_inputs(card, b, hq, hkv, t, s, d, torch.bfloat16)
    lo, hi = flash_attention.decode_tiles(t, s, hq // hkv, causal, window)
    for splits in sorted({1, 3, hi - lo, hi - lo + 2} - {0}):
        before = flash_attention.launches["flash_decode_bf16"]
        out, lse = flash_attention.flash_decode_cuda(q, k, v, causal=causal, window=window,
                                                     splits=splits, return_lse=True)
        assert flash_attention.launches["flash_decode_bf16"] == before + 1
        alone = flash_attention.flash_decode_cuda(q, k, v, causal=causal, window=window,
                                                  splits=splits)
        _, want = flash_attention.flash_decode_plain(q, k, v, causal=causal, window=window,
                                                     splits=splits, return_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(out, alone), f"{splits} splits"
        assert lse.shape == (b, hq, t) and lse.dtype == torch.float32
        torch.testing.assert_close(lse, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,window", ATTENTION_CASES + ATTENTION_MORE[:6])
def test_f32_kernels_lse_matches_the_plain_lse(card, b, hq, hkv, t, s, d, causal, window):
    """flash_attention_f32 with ``return_lse``: each row's log-sum-exp within
    1e-4 of the plain attention's, its output bit-equal to the call
    without it."""
    q, k, v = _attention_inputs(card, b, hq, hkv, t, s, d, torch.float32)
    assert flash_attention._route(q, k, v, window) == "flash_attention_f32"
    out, lse = flash_attention.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                                    return_lse=True)
    alone = flash_attention.flash_attention_cuda(q, k, v, causal=causal, window=window)
    _, want = flash_attention.flash_attention_plain(q, k, v, causal=causal, window=window,
                                                    return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, alone)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-4)


def test_fused_decode_on_two_streams_equals_serial_calls(card):
    """Two decode calls in flight on two streams, each with its own counters,
    give what the same calls give one after another."""
    b, hq, hkv, t, s, d = 8, 32, 8, 1, 1088, 128
    ins = [_attention_inputs(card, b, hq, hkv, t, s, d, torch.bfloat16, seed=i) for i in (1, 2)]
    serial = [flash_attention.flash_attention_cuda(*x) for x in ins]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(card) for _ in ins]
    outs = [None, None]
    for _ in range(3):
        for i, (x, st) in enumerate(zip(ins, streams)):
            st.wait_stream(torch.cuda.current_stream(card))
            with torch.cuda.stream(st):
                outs[i] = [flash_attention.flash_attention_cuda(*x) for _ in range(4)]
        torch.cuda.synchronize()
        for i, st in enumerate(streams):
            for out in outs[i]:
                assert torch.equal(out, serial[i])
            assert not bool(flash_attention.scratch.counters(card, st.cuda_stream).any())


def test_fused_decode_replayed_in_a_cuda_graph_equals_the_eager_call(card):
    b, hq, hkv, t, s, d = 8, 32, 8, 1, 1088, 128
    q, k, v = _attention_inputs(card, b, hq, hkv, t, s, d, torch.bfloat16)
    eager = flash_attention.flash_attention_cuda(q, k, v)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        flash_attention.flash_attention_cuda(q, k, v)  # the side stream's counters, before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = flash_attention.flash_attention_cuda(q, k, v)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert not bool(flash_attention.scratch.counters(card, side.cuda_stream).any())


# The f32 kernels: the phase-3 shapes of chip_smoke.py (the reference's cases,
# every compiled head dim, ragged T and S, windows, T < S, the smoke LM's
# shapes, the full-width prefill) on the TMA kernel and on the SIMT kernel.
F32_CASES = ATTENTION_CASES + ATTENTION_MORE + [
    (4, 4, 2, 16, 16, 16, True, None), (4, 4, 2, 1, 32, 16, False, None),
    (1, 8, 1, 200, 333, 8, True, 70), (1, 4, 4, 129, 129, 32, True, 64),
    (2, 8, 2, 1, 700, 128, True, 100), (1, 16, 2, 77, 200, 64, False, None),
]


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,window", F32_CASES)
@pytest.mark.parametrize("entry", ["flash_attention_f32", "flash_attention_f32_simt"])
def test_f32_attention_entries_match_plain(card, b, hq, hkv, t, s, d, causal, window, entry):
    q, k, v = _attention_inputs(card, b, hq, hkv, t, s, d, torch.float32)
    assert flash_attention._route(q, k, v, window) == "flash_attention_f32"
    before = dict(flash_attention.launches)
    got = flash_attention._launch(entry, q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert {n: flash_attention.launches[n] - before[n] for n in before} == {
        n: int(n == entry) for n in before}
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_f32_simt_entry_takes_the_views_tma_cannot_read(card):
    b, hq, hkv, t, s, d = 2, 8, 2, 5, 77, 64
    rng = np.random.default_rng(4)
    flat = torch.from_numpy(rng.standard_normal(1 + b * hkv * s * d, dtype=np.float32)).to(card)
    k_odd = flat[1:].view(b, hkv, s, d)
    q = torch.from_numpy(rng.standard_normal((b, hq, t, d), dtype=np.float32)).to(card)
    wide = torch.from_numpy(rng.standard_normal((b, hkv, s, d + 2), dtype=np.float32)).to(card)
    k_rows = wide[..., :d]  # rows 264 bytes apart
    for kk in (k_odd, k_rows):
        assert flash_attention._route(q, kk, kk) == "flash_attention_f32_simt"
        before = flash_attention.launches["flash_attention_f32_simt"]
        got = flash_attention.flash_attention_cuda(q, kk, kk, causal=True)
        assert flash_attention.launches["flash_attention_f32_simt"] == before + 1
        want = flash_attention.flash_attention_plain(q, kk, kk, causal=True)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("t,entry", [(1, "flash_decode_bf16"), (40, "flash_attention_bf16_wgmma")])
def test_bf16_attention_entries_read_views_in_place(card, t, entry):
    """The model's layouts on the new entries: (B, T, H, D) activations seen
    as (B, H, T, D), a (B, S, KV, D) cache sliced to its valid length; and
    the same with k one element into its storage, which goes to the SIMT
    kernel."""
    b, hq, hkv, s_len, kv_len, d = 2, 8, 2, 90, 77, 128
    rng = np.random.default_rng(3)
    bf = torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((b, t, hq, d), dtype=np.float32)).to(card, bf)
    kc = torch.from_numpy(rng.standard_normal((b, s_len, hkv, d), dtype=np.float32)).to(card, bf)
    vc = torch.from_numpy(rng.standard_normal((b, s_len, hkv, d), dtype=np.float32)).to(card, bf)
    qv, kv_, vv = q.transpose(1, 2), kc[:, :kv_len].transpose(1, 2), vc[:, :kv_len].transpose(1, 2)
    assert flash_attention._route(qv, kv_, vv) == entry
    for causal in (False, True):
        got = flash_attention.flash_attention_cuda(qv, kv_, vv, causal=causal)
        want = flash_attention.flash_attention_plain(qv, kv_, vv, causal=causal)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
        assert got.transpose(1, 2).is_contiguous()
    flat = torch.from_numpy(rng.standard_normal(1 + b * hkv * kv_len * d, dtype=np.float32))
    k_odd = flat.to(card, bf)[1:].view(b, hkv, kv_len, d)
    assert flash_attention._route(qv, k_odd, k_odd) == "flash_attention_bf16_simt"
    before = flash_attention.launches["flash_attention_bf16_simt"]
    got = flash_attention.flash_attention_cuda(qv, k_odd, k_odd, causal=True)
    assert flash_attention.launches["flash_attention_bf16_simt"] == before + 1
    want = flash_attention.flash_attention_plain(qv, k_odd, k_odd, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


# The f32 GEMM's TMA kernel (matmul_f32) and the SIMT kernel it replaced on
# the path (matmul_f32_simt). Products of at most 512 a side are held
# against the plain version at the reference's 1e-5, larger ones against f64
# with 16*K*u*rms(A)*rms(B), chip_smoke.py's rule and bound (its
# _exact_check says why).
F32_TMA_SHAPES = [(8, 8, 8), (128, 128, 128), (257, 1, 128), (1000, 1000, 1000),
                  (200, 72, 136), (4096, 4096, 4096), (132, 520, 260)]
F32_TILES = [(128, 128), (128, 256)]


def _f32_operands(card, m, k, n, layout, seed=0):
    rng = np.random.default_rng(seed)
    a_np = rng.standard_normal((m, k), dtype=np.float32)
    a = (torch.from_numpy(a_np.T.copy()).to(card).T if layout == "tn"
         else torch.from_numpy(a_np).to(card))
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(card)
    return a, b


def _rms(t) -> float:
    return t.double().square().mean().sqrt().item()


def _assert_f32_product(got, a, b):
    k = a.shape[-1]
    want = matmul.matmul_plain(a, b)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if max(a.shape[-2], k, b.shape[-1]) <= 512:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    exact = torch.matmul(a.double(), b.double())
    atol = 16 * k * U_F32 * _rms(a) * _rms(b)
    assert bool(torch.isfinite(got).all())
    assert (got.double() - exact).abs().max().item() <= atol
    assert (want.double() - exact).abs().max().item() <= atol


@pytest.mark.parametrize("m,k,n", F32_TMA_SHAPES)
@pytest.mark.parametrize("layout", ["nn", "tn"])
@pytest.mark.parametrize("tile", F32_TILES, ids=["128x128", "128x256"])
def test_f32_matmul_tma_entry_matches_plain(card, m, k, n, layout, tile):
    a, b = _f32_operands(card, m, k, n, layout)
    assert matmul._route(a, b) == "matmul_f32"
    before = dict(matmul.launches)
    got = matmul.matmul_cuda(a, b, block_m=tile[0], block_n=tile[1])
    torch.cuda.synchronize()
    assert {k_: matmul.launches[k_] - before[k_] for k_ in before} == {
        k_: int(k_ == "matmul_f32") for k_ in before}
    _assert_f32_product(got, a, b)


def test_f32_matmul_tma_entry_is_deterministic(card):
    a, b = _f32_operands(card, 1000, 1000, 1000, "nn", seed=3)
    first = matmul.matmul_cuda(a, b)
    assert all(torch.equal(first, matmul.matmul_cuda(a, b)) for _ in range(3))


@pytest.mark.parametrize("shared", [True, False], ids=["shared_a", "both_batched"])
@pytest.mark.parametrize("tile", F32_TILES, ids=["128x128", "128x256"])
@pytest.mark.parametrize("shape", [(3, 130, 72, 52), (4, 256, 2304, 900)],
                         ids=["ragged", "im2col"])
def test_f32_batched_matmul_tma_entry_matches_plain(card, shared, tile, shape):
    """Convolution's im2col product (a shared weight, 4 of its 64 images)
    and a ragged batch, a broadcast A or both operands batched."""
    batch, m, k, n = shape
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((m, k) if shared else (batch, m, k),
                                             dtype=np.float32)).to(card)
    b = torch.from_numpy(rng.standard_normal((batch, k, n), dtype=np.float32)).to(card)
    assert matmul._route(a, b) == "matmul_f32"
    before = dict(matmul.launches)
    got = matmul.matmul_cuda(a, b, block_m=tile[0], block_n=tile[1])
    torch.cuda.synchronize()
    assert {k_: matmul.launches[k_] - before[k_] for k_ in before} == {
        k_: int(k_ == "matmul_f32_batched") for k_ in before}
    assert got.shape == (batch, m, n)
    _assert_f32_product(got, a, b)


def test_f32_matmul_simt_takes_what_tma_cannot(card):
    """A row stride that is not a multiple of 4 floats, a base off 16 bytes,
    a column-major B and an odd batch stride go to the SIMT kernel and
    agree with the plain version there."""
    x = torch.randn(1, 256, device=card)
    y33 = torch.randn(256, 33, device=card)  # row stride 33
    odd = torch.randn(64 * 64 + 4, device=card)[1:1 + 64 * 64].view(64, 64)  # 4 bytes in
    col_b = torch.randn(72, 64, device=card).T  # (64, 72), column-major
    batched = torch.randn(3 * 64 * 64 + 3, device=card)[: 3 * 64 * 64 + 3].as_strided(
        (3, 64, 64), (64 * 64 + 1, 64, 1))  # batch stride 4097
    sq = torch.randn(64, 64, device=card)
    for a, b, key in ((x, y33, "matmul_f32_simt"), (odd, sq, "matmul_f32_simt"),
                      (sq, odd, "matmul_f32_simt"), (sq, col_b, "matmul_f32_simt"),
                      (sq, batched, "matmul_f32_simt_batched")):
        assert matmul._route(a, b) == "matmul_f32_simt"
        before = matmul.launches[key]
        got = matmul.matmul_cuda(a, b)
        assert matmul.launches[key] == before + 1
        torch.testing.assert_close(got, matmul.matmul_plain(a, b), rtol=1e-5, atol=1e-5)


def test_f32_matmul_simt_entry_runs_on_tma_operands(card):
    """The replaced kernel, named explicitly, on operands TMA takes (how
    phase 5 times it beside its successor): counted as itself."""
    a, b = _f32_operands(card, 300, 200, 100, "tn")
    before = matmul.launches["matmul_f32_simt"]
    got = matmul._launch("matmul_f32_simt", a, b)
    assert matmul.launches["matmul_f32_simt"] == before + 1
    torch.testing.assert_close(got, matmul.matmul_plain(a, b), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="no compiled tile"):
        matmul._launch("matmul_f32_simt", a, b, block_n=256)
    with pytest.raises(ValueError, match="no compiled tile"):
        matmul.matmul_cuda(a, b, block_n=192)


def test_gemm_f32_rows_on_the_card_launch_the_tma_kernel(card):
    before = dict(matmul.launches)
    res = Engine().run(ExecutionPlan(
        names=("gemm_f32_nn", "gemm_f32_tn", "connected"), preset=0, iters=2, warmup=1,
        include_backward=False, impl="kernel",
    ))
    assert [r.status for r in res.records] == ["ok"] * 3, [r.error for r in res.records]
    calls = 1 + 1 + 1 + 2 * (1 + 4)
    deltas = {k: matmul.launches[k] - before[k] for k in before}
    assert deltas == {k: 3 * calls if k == "matmul_f32" else 0 for k in before}


# The onesweep sort: lengths around one tile (4096 keys), the path's 2^24
# and one past it; key patterns that stress the look-back.
ONESWEEP_LENGTHS = [1, 4095, 4096, 4097, 2**24, 2**24 + 12345]


def _special_keys(kind: str, n: int, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if kind == "float32_special":  # NaN, both zeros and both infinities among ties
        pool = torch.tensor([float("nan"), 0.0, -0.0, float("inf"), -float("inf"), 1.5, -1.5,
                             -2.0**-149, 3.4e38], device=dev)
        return pool[torch.randint(0, len(pool), (n,), generator=gen, device=dev)]
    if kind == "all_equal":
        return torch.full((n,), 12345, dtype=torch.int32, device=dev)
    # int32 keys that differ only in their top byte: the last pass moves all.
    top = torch.randint(-128, 128, (n,), generator=gen, device=dev, dtype=torch.int32)
    return (top << 24) | 0x00abcdef


@pytest.mark.parametrize("n", ONESWEEP_LENGTHS)
@pytest.mark.parametrize("kind", ["int32_full", "float32_special", "all_equal", "top_byte"])
def test_onesweep_sort_equals_the_stable_plain_version(card, n, kind):
    gen = torch.Generator(card).manual_seed(n + 7)
    keys = (_sort_keys(kind, n, gen) if kind == "int32_full"
            else _special_keys(kind, n, gen))
    vals = torch.arange(n, dtype=torch.int32, device=card)
    key = "sort_kv_f32" if keys.dtype == torch.float32 else "sort_kv_i32"
    before = bitonic_sort.launches[key]
    ko, vo = bitonic_sort.sort_kv_cuda(keys, vals)
    torch.cuda.synchronize()
    assert bitonic_sort.launches[key] == before + 1
    pk, pv = bitonic_sort.sort_kv_plain(keys, vals)
    assert torch.equal(ko.view(torch.int32), pk.view(torch.int32))
    assert torch.equal(vo, pv)


def test_sort_scratch_bytes_match_the_c_entry(card):
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.function("radix_sort_scratch_bytes", [ctypes.c_longlong])
    assert _build.function("radix_sort_tile", [])() == bitonic_sort.TILE
    for n in (1, 4095, 4096, 4097, 2**24, 2**31 - 1):
        assert fn(n) == sum(bitonic_sort.scratch_bytes(n).values())


def test_sort_row_on_the_card_launches_the_kernel_once_per_sort(card):
    before = dict(bitonic_sort.launches)
    res = Engine().run(ExecutionPlan(
        names=("sort",), preset=0, iters=2, warmup=1, impl="kernel",
    ))
    assert [r.status for r in res.records] == ["ok"]
    calls = 1 + 1 + 1 + 2 * (1 + 4)
    assert {k: bitonic_sort.launches[k] - before[k] for k in before} == {
        "sort_kv_i32": calls, "sort_kv_f32": 0}


# ----------------------------------------- levels 0-2 without a kernel

LEVELS_WITHOUT_KERNEL = (
    "devicemem_stream", "devicemem_reduce", "devicemem_vmem", "busspeeddownload",
    "busspeedreadback", "bfs", "gups", "pathfinder", "cfd", "dwt2d_53", "dwt2d_97",
    "kmeans", "lavamd", "mandelbrot_flat", "mandelbrot_ms", "nw", "particlefilter",
)


def _static_loop(name):
    """(its graph cache, the eager loop) of a row whose loop is graphed."""
    from repro_torch.bench.level0 import devicemem
    from repro_torch.bench.level1 import pathfinder
    from repro_torch.bench.level2 import nw

    return {
        "devicemem_vmem": (devicemem.GRAPHS, lambda x, y: devicemem.vmem_steps(x)),
        "pathfinder": (pathfinder.GRAPHS, pathfinder.min_path_steps),
        "nw": (nw.GRAPHS, nw.wavefront),
    }[name]


@pytest.mark.parametrize("name", ["devicemem_vmem", "pathfinder", "nw"])
def test_graphed_static_loops_are_bit_equal_to_their_eager_loops(card, name):
    from repro_torch.core.registry import get_benchmark

    cache, eager_loop = _static_loop(name)
    wl = get_benchmark(name).build_preset(2)
    args = tuple(a.to(card) for a in wl.make_inputs(0))
    eager = eager_loop(*args)
    cache.clear()
    first = wl.fn(*args)  # eager, then captured
    torch.cuda.synchronize()
    assert len(cache) == 1 and torch.equal(first, eager)
    mem = torch.cuda.memory_allocated(card)
    outs = []
    for _ in range(3):
        outs.append(wl.fn(*args))  # a replay
        torch.cuda.synchronize()
        assert torch.equal(outs[-1], eager)
    assert outs[0] is outs[1] is outs[2]  # the graph's static output
    assert torch.cuda.memory_allocated(card) == mem and len(cache) == 1
    other = wl.fn(*(a.clone() for a in args))  # another address: another capture
    assert len(cache) == 2 and torch.equal(other, eager)
    cache.clear()


def test_levels_without_a_kernel_on_the_card_launch_no_kernel(card):
    from repro_torch.kernels import ops

    before = {op: dict(mod.launches) for op, mod in ops.KERNEL_OPS.items()}
    res = Engine().run(ExecutionPlan(
        names=LEVELS_WITHOUT_KERNEL, preset=1, iters=2, warmup=1, impl="kernel",
    ))
    assert len(res.records) == len(LEVELS_WITHOUT_KERNEL)
    for r in res.records:
        assert r.status == "ok", (r.name, r.error)
        want = "no_jit" if r.name.startswith("busspeed") else "no_kernel"
        assert (r.impl, r.impl_fallback) == ("torch", want)
        assert (r.us_per_call_windowed is None) == (want == "no_jit")
    assert {op: dict(mod.launches) for op, mod in ops.KERNEL_OPS.items()} == before


def test_hostbus_rows_move_bytes_across_the_bus(card):
    from repro_torch.core.registry import get_benchmark

    engine = Engine()
    plan = ExecutionPlan(names=("busspeeddownload",), preset=1)
    down = get_benchmark("busspeeddownload").build_preset(1)
    src, dst = engine._stage_place(down, down.make_inputs(0), plan)
    assert src.device.type == "cpu" and dst.device.type == "cuda"
    out = down.fn(src, dst)
    assert out.device.type == "cuda" and torch.equal(out.cpu(), src)
    up = get_benchmark("busspeedreadback").build_preset(1)
    (dev,) = engine._stage_place(up, up.make_inputs(0), plan)
    assert dev.device.type == "cuda"
    host = up.fn(dev)
    assert host.device.type == "cpu" and torch.equal(host, dev.cpu())


def test_particlefilter_on_the_card_draws_the_same_numbers_each_call(card):
    from repro_torch.core.registry import get_benchmark

    wl = get_benchmark("particlefilter").build_preset(2)
    meas, seed = wl.make_inputs(0)
    meas = meas.to(card)
    first, again = wl.fn(meas, seed), wl.fn(meas, seed)
    assert torch.equal(first, again) and not torch.equal(first, wl.fn(meas, seed + 1))
    wl.validate(first, (meas, seed))


# -- the feature studies' kernels and CUDA features ------------------------

# (n, max_iter): the Dynamic Parallelism study's sizes, and the suite's
# preset-4 image.
MANDELBROT_CASES = [(128, 256), (256, 256), (512, 256), (2048, 1024)]


@pytest.mark.parametrize("n,max_iter", MANDELBROT_CASES)
def test_mandelbrot_kernels_are_bit_equal_to_escape_time(card, n, max_iter):
    from repro_torch.bench.level2.mandelbrot import escape_time, pixel_grid
    from repro_torch.kernels import mandelbrot

    c = pixel_grid(n).to(card)
    want = escape_time(c, max_iter)
    flat = mandelbrot.mandelbrot_flat_cuda(c, max_iter)
    status = mandelbrot.DpStatus(card)
    adaptive = mandelbrot.mandelbrot_dp_cuda(c, max_iter, status=status)
    children = status.check()
    assert torch.equal(flat, want)
    assert torch.equal(adaptive, want)
    # One child grid a mixed tile; past 128 px some tiles are interior.
    mixed = mandelbrot.mixed_tiles_plain(c, max_iter)
    assert children == mixed
    assert 0 < mixed <= (n // 32) ** 2
    assert n == 128 or mixed < (n // 32) ** 2


def test_mandelbrot_dp_checks_its_own_status_without_one(card):
    from repro_torch.bench.level2.mandelbrot import mariani_silver, pixel_grid
    from repro_torch.kernels import mandelbrot

    c = pixel_grid(256).to(card)
    before = dict(mandelbrot.launches)
    got = mandelbrot.mandelbrot_dp_kernel(c, 64)
    assert torch.equal(got, mariani_silver(c, 64))
    assert mandelbrot.launches["mandelbrot_dp_i32"] == before["mandelbrot_dp_i32"] + 1
    with pytest.raises(ValueError, match="multiple of the tile"):
        mandelbrot.mandelbrot_dp_cuda(pixel_grid(48).to(card), 64)


def test_managed_buffer_round_trip_advice_and_prefetch(card):
    from repro_torch.kernels import managed

    host = np.arange(1 << 20, dtype=np.int32)
    buf = managed.ManagedBuffer.from_host(host)
    t = buf.tensor()
    assert t.is_cuda and t.dtype == torch.int32 and t.data_ptr() == buf.ptr
    concurrent = managed.concurrent_managed_access()
    assert concurrent in (0, 1)
    if concurrent:
        buf.advise("preferred_location", 0)
        buf.prefetch(0)
    t.mul_(3)  # the card writes the pages (faulting them over if not prefetched)
    torch.cuda.synchronize()
    if concurrent:
        buf.prefetch(managed.HOST)
        torch.cuda.synchronize()
    np.testing.assert_array_equal(buf.host_view(), host * 3)  # read back by the host
    assert int(t.sum()) == int(host.astype(np.int64).sum() * 3)
    del t  # the tensor held the buffer; the buffer frees on close
    buf.close()
    with pytest.raises(ValueError, match="freed"):
        buf.host_view()


def test_async_launch_on_four_streams_equals_serial_calls(card):
    from repro_torch.core import features

    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal((512, 512), dtype=np.float32)).to(card)
          for _ in range(4)]

    def work(x):
        for _ in range(8):
            x = torch.tanh(x @ x.T * 1e-2)
        return x

    want = [work(x) for x in xs]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    got = features.async_launch(work, [(x,) for x in xs])
    end.record()
    end.synchronize()
    # The pair on the current stream covers the side streams' work: when its
    # second event has passed, every side stream is idle.
    assert all(s.query() for s in features._pool(card)[:4])
    assert start.elapsed_time(end) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_hyperq_study_captures_each_graph_once_across_the_sweep(card):
    from repro_torch.benchmarks import feat_hyperq
    from repro_torch.core import graphs

    made = []

    def new_graph():
        made.append(graphs._CudaGraph())
        return made[-1]

    cache = graphs.GraphCache(capacity=128, new_graph=new_graph)
    rows = feat_hyperq.rows(graphs=cache)
    n = max(feat_hyperq.INSTANCES)
    # Every instance's graph, and one batched graph a sweep point, once.
    assert len(made) == n + len(feat_hyperq.INSTANCES) == len(cache)
    assert [r[0] for r in rows] == [f"feat_hyperq.n{k}" for k in feat_hyperq.INSTANCES]


def test_lanes_wait_on_cuda_events(card):
    from repro_torch.serve.lanes import run_closed_loop, serve_loop
    from repro_torch.serve.loadgen import closed_loop_schedule

    x = torch.ones(1024, 1024, device=card)
    done = run_closed_loop(lambda: x @ x, concurrency=8, n_lanes=4, duration_s=5.0,
                           max_requests=32)
    assert sorted(c.index for c in done) == list(range(32))
    assert torch.cuda.current_stream().query()  # drained: nothing left in flight
    for window in (1, 4):
        done = serve_loop(lambda: x @ x, closed_loop_schedule(8), window=window)
        assert len(done) == 8 and torch.cuda.current_stream().query()


def test_stagers_on_managed_memory_give_the_resident_depths(card):
    from repro_torch.bench.level1.bfs import bfs_depths, make_random_graph
    from repro_torch.core import features

    n, e = 1 << 13, 1 << 16
    src, dst = make_random_graph(n, e, seed=0)
    want = bfs_depths(n, torch.from_numpy(src).to(card), torch.from_numpy(dst).to(card), 0)
    stager = features.DemandStager()
    for _ in range(2):
        stager.evict()
        assert torch.equal(bfs_depths(n, stager.get(src), stager.get(dst), 0), want)
    pf = features.Prefetcher()
    for _ in range(2):
        pf.evict()
        pf.prefetch("g", (src, dst))
        s, d = pf.get("g")
        assert torch.equal(bfs_depths(n, s, d, 0), want)


def test_feature_studies_run_on_the_card_at_small_sizes(card):
    from repro_torch.benchmarks import (
        feat_coop_groups,
        feat_dynamic_parallelism,
        feat_unified_memory,
    )
    from repro_torch.kernels import srad_stencil

    before = dict(srad_stencil.launches)
    rows = feat_coop_groups.rows((64, 256))
    assert [r[0] for r in rows] == ["feat_cg.srad.64x64", "feat_cg.srad.256x256"]
    calls = 2 * (1 + feat_coop_groups.ITERS + feat_coop_groups.WARMUP)
    for name in ("srad_fused_f32", "srad_phase1_f32", "srad_phase2_f32"):
        assert srad_stencil.launches[name] - before[name] == calls
    rows = feat_unified_memory.rows(((1 << 10, 1 << 13),))
    assert rows[0][0] == "feat_um.bfs.n1024"
    assert "concurrent_managed_access=1" in rows[0][2]
    rows = feat_dynamic_parallelism.rows(64, sizes=(128, 256))
    assert [r[2].split(";")[-1] for r in rows] == ["mixed_tiles=16", "mixed_tiles=60"]


def test_bf16_matmul_refuses_the_wide_tile_before_launching_and_tune_skips_it(card):
    from repro_torch.kernels.ops import TileRefused

    gen = torch.Generator(device=card).manual_seed(0)
    a, b = (torch.randn(256, 256, generator=gen, device=card).bfloat16() for _ in range(2))
    assert matmul._route(a, b) == "matmul_bf16"
    before = dict(matmul.launches)
    with pytest.raises(TileRefused, match="no compiled tile"):
        matmul.matmul_cuda(a, b, block_n=256)
    torch.cuda.synchronize()
    assert matmul.launches == before  # refused before any launch
    res = Engine().run(ExecutionPlan(
        names=("gemm_bf16_nn",), preset=0, iters=2, warmup=1, include_backward=False,
        impl="kernel", tune=True,
    ))
    (rec,) = res.records
    assert rec.status == "ok", rec.error
    assert rec.tuned_params == matmul.F32_TILES[0] and rec.tune_trials == 1
    assert rec.derived.endswith(";tune_refused=1")
    assert matmul.launches["matmul_bf16"] > before["matmul_bf16"]


def test_tune_of_gemm_f32_tn_on_the_card_cold_then_warm(card, tmp_path):
    plan = ExecutionPlan(names=("gemm_f32_tn",), preset=0, iters=2, warmup=1,
                         include_backward=False, impl="kernel", tune=True)
    launched = []

    class Logged(Engine):
        def _time_tune_trial(self, entry, args, plan):
            before = matmul.launches["matmul_f32"]
            us = super()._time_tune_trial(entry, args, plan)
            launched.append(matmul.launches["matmul_f32"] - before)
            return us

    cold = Logged(cache_dir=str(tmp_path))
    (rec,) = cold.run(plan).records
    assert rec.status == "ok", rec.error
    assert rec.tune_trials == 2 and rec.tuned_params in matmul.F32_TILES
    # Each trial: warm-up 1, then min(iters, 3) windows of timing_window calls.
    assert launched == [1 + 2 * plan.timing_window] * 2
    assert cold.disk_cache.tune_stores == 1
    warm = Logged(cache_dir=str(tmp_path))
    (rec2,) = warm.run(plan).records
    assert rec2.status == "ok", rec2.error
    assert rec2.tune_trials == 0 and rec2.tuned_params == rec.tuned_params
    assert warm.disk_cache.tune_hits == 1 and len(launched) == 2
    assert torch.cuda.get_device_name(0).replace(" ", "_") in warm.disk_cache.root


# Batched bf16 products on the TMA + wgmma kernel: the served GEMM's shapes
# scaled down, ragged M, N and K, A batched or broadcast, "nn" and "tn"
# (A's transposed view), and a broadcast B.
BF16_BATCHED = [(4, 256, 256, 256), (3, 200, 72, 136), (2, 1000, 1000, 1000), (5, 64, 64, 64)]


@pytest.mark.parametrize("batch,m,k,n", BF16_BATCHED)
@pytest.mark.parametrize("layout", ["nn", "tn"])
@pytest.mark.parametrize("shared", ["a", "b", None])
def test_batched_bf16_matmul_on_the_tma_kernel_matches_plain(card, batch, m, k, n, layout,
                                                              shared):
    gen = torch.Generator(device=card).manual_seed(batch * m + k)

    def operand(rows, cols, batched, transposed=False):
        shape = (batch,) * batched + ((cols, rows) if transposed else (rows, cols))
        t = torch.randn(*shape, generator=gen, device=card).bfloat16()
        return t.transpose(-1, -2) if transposed else t

    a = operand(m, k, shared != "a", transposed=layout == "tn")
    b = operand(k, n, shared != "b")
    assert matmul._route(a, b) == "matmul_bf16"
    before = dict(matmul.launches)
    got = matmul.matmul_cuda(a, b)
    torch.cuda.synchronize()
    assert {key: matmul.launches[key] - before[key] for key in before} == {
        key: int(key == "matmul_bf16_batched") for key in before}
    assert got.shape == (batch, m, n) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), matmul.matmul_plain(a, b).float(),
                               rtol=2e-2, atol=2e-2)
    # Each product equals the 2-D kernel's on that member: the same tiles,
    # the same order of K.
    for j in range(batch):
        one = matmul.matmul_cuda(a if a.dim() == 2 else a[j], b if b.dim() == 2 else b[j])
        assert torch.equal(got[j], one)


# op, the members' inputs (w = 3), launches a width-3 call makes, tolerance.
def _rule_cases(card):
    gen = torch.Generator(device=card).manual_seed(7)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=card).to(dtype)

    return {
        "matmul_f32": (lambda x, y: ops.matmul(x, y), (r(3, 130, 72), r(3, 72, 96)),
                       {"matmul_f32_batched": 1}, 1e-5),
        "matmul_bf16": (lambda x, y: ops.matmul(x, y),
                        (r(3, 256, 128, dtype=torch.bfloat16), r(3, 128, 256, dtype=torch.bfloat16)),
                        {"matmul_bf16_batched": 1}, 2e-2),
        "softmax": (lambda x: ops.softmax(x), (r(3, 64, 1000),), {"softmax_f32": 1}, 1e-5),
        "lrn": (lambda x: ops.lrn(x, size=5), (r(3, 2, 64, 8, 8),), {"lrn_f32": 1}, 1e-5),
        "avgpool": (lambda x: ops.avgpool(x, ksize=2), (r(3, 2, 8, 16, 16),),
                    {"avgpool_f32": 1}, 1e-6),
        "attention": (lambda q, k, v: ops.attention(q, k, v, causal=True),
                      (r(3, 2, 4, 64, 64, dtype=torch.bfloat16),
                       r(3, 2, 2, 64, 64, dtype=torch.bfloat16),
                       r(3, 2, 2, 64, 64, dtype=torch.bfloat16)),
                      {"flash_attention_bf16_wgmma": 1}, 2e-2),
        "prefix_scan": (lambda x: ops.prefix_scan(x), (r(3, 5000),), {"prefix_scan_f32": 3},
                        1e-4),
        "sort_kv": (lambda k, v: ops.sort_kv(k, v),
                    (torch.randint(0, 100, (3, 5000), generator=gen, device=card,
                                   dtype=torch.int32),
                     torch.arange(15000, device=card, dtype=torch.int32).view(3, 5000)),
                    {"sort_kv_i32": 3}, 0.0),
        "srad_step": (lambda x: ops.srad_step(x), (r(3, 64, 64).abs() + 0.5,),
                      {"srad_fused_f32": 3}, 0.0),
    }


@pytest.mark.parametrize("case", ["matmul_f32", "matmul_bf16", "softmax", "lrn", "avgpool",
                                  "attention", "prefix_scan", "sort_kv", "srad_step"])
def test_each_ops_batching_rule_launches_the_kernel_and_matches_each_member(card, case):
    """torch.vmap over the kernel route on the card: one launch for the
    folding rules, one a member for the looped ones, each member equal to
    the plain version of that member."""
    fn, args, launched, tol = _rule_cases(card)[case]
    mods = (matmul, softmax, lrn, avgpool, flash_attention, prefix_scan, bitonic_sort,
            srad_stencil)
    before = {k: v for m in mods for k, v in m.launches.items()}
    with ops.force_impl("kernel"):
        got = torch.vmap(fn)(*args)
    torch.cuda.synchronize()
    after = {k: v for m in mods for k, v in m.launches.items()}
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == launched
    got = got if isinstance(got, tuple) else (got,)
    for j in range(3):
        with ops.force_impl("ref"):
            want = fn(*(x[j] for x in args))
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            torch.testing.assert_close(g[j].float(), w.float(), rtol=tol, atol=tol)


def test_served_kernel_rows_launch_once_per_call_of_their_width(card):
    """A mixed, dynamically batched serve of gemm_bf16_nn: every call of
    width > 1 is one matmul_bf16_batched launch, every width-1 call one
    matmul_bf16 launch, and the WMMA kernel never runs."""
    from repro_torch.core.plan import ServeSpec, ShapeBucket

    serve = ServeSpec(mode="open", qps=2000.0, duration_s=0.3, dispatch="dynamic",
                      max_batch=4, batch_budget_us=500.0,
                      mix=(ShapeBucket(preset=0), ShapeBucket(preset=0, overrides=(("n", 128),))))
    before = dict(matmul.launches)
    res = Engine().run(ExecutionPlan(names=("gemm_bf16_nn",), preset=0, iters=1, warmup=0,
                                     include_backward=False, impl="kernel", serve=serve))
    (rec,) = res.records
    assert rec.status == "ok", rec.error
    delta = {k: matmul.launches[k] - before[k] for k in before}
    assert delta["matmul_bf16_wmma"] == delta["matmul_bf16_wmma_batched"] == 0
    assert delta["matmul_bf16_batched"] > 0
    # measure (1 + 1 + 0 + 1 + 4 calls) + build (1 + 2 + 2 / 2 + 2 + 2) + batches
    measure = 1 + 1 + 0 + 1 + 1 * 4
    assert delta["matmul_bf16"] + delta["matmul_bf16_batched"] == (
        measure + 5 + 6 + rec.serve_batches)


def test_a_kernel_launches_from_a_thread_that_never_touched_the_card(card):
    """The threaded serving client's lane threads call the kernels first
    thing: the f32 TMA GEMM (which sets its shared-memory attribute before
    launching) must launch there as on the main thread."""
    import threading

    a = torch.randn(256, 256, device=card)
    b = torch.randn(256, 256, device=card)
    want = matmul.matmul_cuda(a, b)
    out = {}

    def run():
        try:
            out["c"] = matmul.matmul_cuda(a, b)
        except Exception as e:  # noqa: BLE001 — reported below
            out["err"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert "err" not in out, out.get("err")
    torch.cuda.synchronize()
    assert torch.equal(out["c"], want)


def test_two_client_processes_serve_the_bf16_gemm_on_the_card(card, tmp_path):
    """``ServeSpec(client_procs=2)`` on the card: each client process builds
    the row through its own engine and CUDA context, loads the library this
    process built, restores the tune winner this process stored, and
    launches matmul_bf16 once a request it served; the merged stream holds
    every client's requests."""
    from repro_torch.core.plan import ServeSpec
    from repro_torch.core.suite import run_suite
    from repro_torch.dist import launcher

    got = []
    real = launcher.run_distributed

    def keep(**kw):
        got.append(real(ready_timeout_s=300.0, done_timeout_s=120.0,
                        **{k: v for k, v in kw.items()
                           if k not in ("ready_timeout_s", "done_timeout_s")}))
        return got[-1]

    launcher.run_distributed = keep
    try:
        (rec,) = run_suite(
            names=["gemm_bf16_nn"], preset=0, impl="kernel", tune=True, iters=1, warmup=0,
            include_backward=False, verbose=False, cache_dir=str(tmp_path),
            serve=ServeSpec(mode="open", qps=400.0, duration_s=0.5, concurrency=8, lanes=2,
                            client_procs=2),
        )
    finally:
        launcher.run_distributed = real
    assert rec.status == "ok", rec.error
    assert rec.client_procs == 2 and len(rec.proc_qps) == 2 and min(rec.proc_qps) > 0
    (st,) = got
    assert sum(d.requests for d in st.client_dones) == st.requests + st.warmup_requests
    for d in st.client_dones:
        assert d.launches == {"matmul_bf16": d.requests}
        assert d.cache_counters["library_cached"] == 1
        assert d.cache_counters["tune_trials"] == 0 and d.cache_counters["tune_hits"] == 1


# -- training -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTENTION_CASES)
def test_attention_under_autograd_launches_the_kernel_and_its_torch_backward(card, case, dtype):
    """``ops.attention`` on inputs that want a gradient: one launch of the
    routed entry forward, one ``attention_bwd_torch`` backward, gradients
    as autograd of the plain version in f32 (bf16: one rounding, 2^-8)."""
    from repro_torch.kernels.ref import attention_ref

    b, hq, hkv, t, s, d, causal, window = case
    g = torch.Generator(device=card).manual_seed(7)
    q, k, v = (torch.randn(shape, generator=g, device=card).to(dtype).requires_grad_()
               for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d)))
    dout = torch.randn((b, hq, t, d), generator=g, device=card).to(dtype)
    before = dict(flash_attention.launches)
    calls = flash_attention.backward_calls["attention_bwd_torch"]
    out = ops_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in flash_attention.launches.items() if c != before[n]}
    assert sum(launched.values()) == 1, launched
    assert flash_attention.backward_calls["attention_bwd_torch"] == calls + 1
    q32, k32, v32 = (x.detach().float().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(attention_ref(q32, k32, v32, causal=causal, window=window),
                               (q32, k32, v32), dout.float())
    rtol = 0.0 if dtype == torch.float32 else 2.0**-8
    for name, a, w in zip("qkv", got, want, strict=True):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), w, rtol=rtol, atol=1e-5 * w.abs().max().item(),
                                   msg=f"d{name}")


def test_prefetch_copies_each_batch_on_a_side_stream_in_order(card):
    from repro_torch.data import Prefetch, SyntheticLM

    data = SyntheticLM(vocab=300, batch=4, seq=32, seed=1)
    pf = Prefetch(data.batch_at, start_step=2, device=card)
    try:
        it = iter(pf)
        for want_step in (2, 3, 4, 5):
            step, batch = next(it)
            assert step == want_step
            host = data.batch_at(step)
            for key in ("tokens", "labels"):
                assert batch[key].is_cuda
                assert np.array_equal(batch[key].cpu().numpy(), host[key])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# Head dim 80 (hubert-xlarge's) on the entries it routes to: f32 on the SIMT
# kernel, bf16 on the wgmma kernel from 64 packed rows and on the SIMT one
# below; bidirectional and causal, ragged T and S, hubert's group 1 and a
# group of 2, a window, and a batch row of hubert's encoder layer.
D80_CASES = [
    (1, 4, 4, 33, 33, False, None), (2, 4, 4, 17, 17, True, None),
    (1, 4, 2, 45, 77, True, None), (2, 4, 2, 7, 30, False, None), (1, 2, 1, 1, 50, True, 9),
    (2, 16, 16, 100, 100, False, None), (1, 16, 16, 4096, 4096, False, None),
]


@pytest.mark.parametrize("b,hq,hkv,t,s,causal,window", D80_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_80_on_the_simt_entries_matches_plain(card, b, hq, hkv, t, s, causal, window,
                                                       dtype):
    q, k, v = _attention_inputs(card, b, hq, hkv, t, s, 80, dtype)
    entry = flash_attention._route(q, k, v, window)
    rows = hq // hkv * t
    assert entry == ("flash_attention_f32_simt" if dtype == torch.float32
                     else "flash_attention_bf16_wgmma" if rows >= 64
                     else "flash_attention_bf16_simt")
    before = dict(flash_attention.launches)
    got = flash_attention.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert {n: flash_attention.launches[n] - before[n] for n in before} == {
        n: int(n == entry) for n in before}
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = _attention_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# The MoE path's attention: 48 query heads over 8 KV heads (group 6), D 128;
# then the VLM's (qwen2-vl-2b: 12 over 2) prefill and decode.
GROUP6_CASES = [
    ((1, 48, 8, 300, 300, 128), True, 100, "flash_attention_bf16_wgmma"),
    ((2, 48, 8, 1, 4096, 128), False, None, "flash_decode_bf16"),
    ((1, 12, 2, 2048, 2048, 128), True, None, "flash_attention_bf16_wgmma"),
    ((4, 12, 2, 1, 2112, 128), False, None, "flash_decode_bf16"),
]


@pytest.mark.parametrize("shape,causal,window,entry", GROUP6_CASES)
def test_group_six_attention_routes_and_matches_plain(card, shape, causal, window, entry):
    b, hq, hkv, t, s, d = shape
    gen = torch.Generator(device=card).manual_seed(6)
    q = torch.randn(b, hq, t, d, generator=gen, device=card).to(torch.bfloat16)
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device=card).to(torch.bfloat16)
            for _ in range(2))
    assert flash_attention._route(q, k, v, window) == entry
    before = dict(flash_attention.launches)
    got = flash_attention.flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert flash_attention.launches[entry] == before[entry] + 1
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


# Groups that do not divide 128 on the wgmma entry, which gives a CTA group *
# floor(128 / group) packed rows (whole positions): groups 3 (126 rows), 5
# (125), 12 (120) and 48 (96), a ragged T whose last CTA holds fewer
# positions, windows shorter than T, T < S, and D 64 and 80.
WGMMA_GROUP_CASES = [
    ((1, 3, 1, 300, 300, 128), True, None),  # 8 CTAs a head, the last of 6 positions
    ((2, 15, 3, 77, 77, 128), True, 20),  # group 5, window 20 < T
    ((1, 24, 2, 100, 160, 128), True, None),  # group 12, T < S
    ((1, 48, 1, 33, 33, 128), False, None),  # group 48, 17 CTAs, the last of one position
    ((1, 96, 2, 70, 200, 64), True, 50),  # group 48 at D 64, window 50 < T
    ((2, 6, 1, 50, 50, 80), True, 17),  # group 6 at D 80
    ((1, 12, 4, 130, 130, 80), False, None),  # group 3 at D 80, bidirectional
]


@pytest.mark.parametrize("shape,causal,window", WGMMA_GROUP_CASES)
def test_wgmma_prefill_at_groups_that_do_not_divide_128_matches_plain(card, shape, causal,
                                                                    window):
    b, hq, hkv, t, s, d = shape
    q, k, v = _attention_inputs(card, b, hq, hkv, t, s, d, torch.bfloat16, seed=hq)
    assert flash_attention._route(q, k, v, window) == "flash_attention_bf16_wgmma"
    before = dict(flash_attention.launches)
    got = flash_attention.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert {n: flash_attention.launches[n] - before[n] for n in before} == {
        n: int(n == "flash_attention_bf16_wgmma") for n in before}
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


# The prefills above, hubert's at D 80 and the group-6 ones, forced onto the
# SIMT entry they left: it stays held against the plain version.
SIMT_HELD_CASES = [(*shape, causal, window) for shape, causal, window in WGMMA_GROUP_CASES] + [
    (*shape, causal, window) for shape, causal, window, entry in GROUP6_CASES
    if entry == "flash_attention_bf16_wgmma"] + [
    (b, hq, hkv, t, s, 80, causal, window) for b, hq, hkv, t, s, causal, window in D80_CASES
    if hq // hkv * t >= 64]


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,window", SIMT_HELD_CASES)
def test_the_simt_entry_forced_at_the_wgmma_layouts_matches_plain(card, b, hq, hkv, t, s, d,
                                                                   causal, window):
    q, k, v = _attention_inputs(card, b, hq, hkv, t, s, d, torch.bfloat16, seed=hq + 1)
    before = dict(flash_attention.launches)
    got = flash_attention._launch("flash_attention_bf16_simt", q, k, v, causal=causal,
                                  window=window)
    torch.cuda.synchronize()
    assert {n: flash_attention.launches[n] - before[n] for n in before} == {
        n: int(n == "flash_attention_bf16_simt") for n in before}
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_moe_smoke_model_on_the_card_matches_the_plain_route(card, arch):
    """The f32 smoke config: the kernel route's logits (flash_attention_f32,
    one launch a layer) within attention's 2e-4 of the plain route's."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = Model(cfg, device=card)
    model.init_weights(torch.Generator(device=card).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 32), device=card)
    before = dict(flash_attention.launches)
    with torch.inference_mode():
        got = model(tokens)
        with ops.force_impl("ref"):
            want = model(tokens)
    delta = {n: c - before[n] for n, c in flash_attention.launches.items() if c != before[n]}
    assert delta == {"flash_attention_f32": cfg.n_layers}
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["bfs", "where", "nw", "mandelbrot_flat", "mandelbrot_ms"])
def test_repaired_rows_at_width_two_equal_their_width_one_calls(card, name):
    from repro_torch.core.engine import _stack_members, bind_impl
    from repro_torch.core.registry import get_benchmark

    wl = get_benchmark(name).build_preset(0)
    members = [wl.make_inputs(0), wl.make_inputs(1)]
    args, in_dims = _stack_members(members, "cuda")
    batched = bind_impl(torch.vmap(wl.fn, in_dims=in_dims, randomness="different"), wl,
                        "kernel")
    got = batched(*args)
    one = bind_impl(wl.fn, wl, "kernel")
    for j, inputs in enumerate(members):
        want = one(*(x.to(card) if isinstance(x, torch.Tensor) else x for x in inputs))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,), strict=True):
            assert torch.equal(g[j], w), (name, j)
