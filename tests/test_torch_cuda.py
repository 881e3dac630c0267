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
    lrn,
    matmul,
    prefix_scan,
    softmax,
    srad_stencil,
)
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
SCAN_LENGTHS = [8, 1000, 4096, 5, 2**20 + 3]
SORT_LENGTHS = [1, 2, 1000, 4096, 5000, 2**20 + 3]
U_F32 = 2.0**-24


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
    key = "matmul_f32_batched" if dtype == torch.float32 else "matmul_bf16_batched"
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
    res = Engine().run(ExecutionPlan(
        names=("gemm_bf16_tn", "softmax"), preset=0, iters=2, warmup=1,
        include_backward=False, impl="kernel",
    ))
    assert [r.status for r in res.records] == ["ok", "ok"]
    assert all(r.impl_interpret is False for r in res.records)
    calls = 1 + 1 + 1 + 2 * (1 + 4)
    after = sum(matmul.launches.values()), sum(softmax.launches.values())
    assert (after[0] - before[0], after[1] - before[1]) == (calls, calls)


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
    assert deltas == {
        "matmul_f32": 0, "matmul_bf16": 0, "matmul_f32_batched": calls,
        "matmul_bf16_batched": 0, "lrn_f32": calls, "avgpool_f32": calls,
    }


@pytest.mark.parametrize("h,w", SRAD_SHAPES)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_srad_kernel_matches_plain(card, h, w, fused):
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0.2, 1.0, size=(h, w)).astype(np.float32)).to(card)
    key = "srad_fused_f32" if fused else "srad_phase1_f32"
    before = srad_stencil.launches[key]
    got = srad_stencil.srad_step_cuda(img, fused=fused)
    torch.cuda.synchronize()
    assert srad_stencil.launches[key] == before + 1
    # tests/test_kernels_misc.py:52
    torch.testing.assert_close(got, srad_stencil.srad_step_plain(img), rtol=1e-5, atol=1e-6)


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
        "srad_fused_f32": 4 * calls, "srad_phase1_f32": 4 * calls,
        "srad_phase2_f32": 4 * calls,
    }
