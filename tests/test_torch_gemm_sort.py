"""The f32 GEMM's routing between its TMA kernel (``matmul_f32``) and its
SIMT kernel (``matmul_f32_simt``), its compiled tiles, and the onesweep
sort's scratch sizes: pure Python over shapes, strides and addresses, so
they run here without a card. The kernels themselves are held against
their plain versions in ``tests/test_torch_cuda.py`` (on a card) and the
plain versions against the reference in ``tests/test_torch_kernels.py``."""

import pytest
import torch

from repro_torch.core.engine import bind_impl
from repro_torch.core.registry import get_benchmark
from repro_torch.kernels import bitonic_sort as tsort
from repro_torch.kernels import matmul as tmatmul
from repro_torch.kernels import ops


def _f(*shape):
    return torch.empty(*shape, dtype=torch.float32)


def _off16(*shape):
    """A row-major f32 tensor whose base lies 4 bytes past 16-byte alignment."""
    n = 1
    for s in shape:
        n *= s
    t = _f(n + 4)[1:1 + n].view(*shape)
    assert t.data_ptr() % 16 == 4
    return t


TMA_CASES = {
    # the gemm "nn" and "tn" rows at preset 4 (tn hands the kernel a.T)
    "nn_4096": (lambda: (_f(4096, 4096), _f(4096, 4096)), (0, 4096, 0, 4096, 0)),
    "tn_4096": (lambda: (_f(4096, 4096).T, _f(4096, 4096)), (1, 4096, 0, 4096, 0)),
    # Connected at preset 4: (1024 x 4096) . (4096 x 4096)
    "connected": (lambda: (_f(1024, 4096), _f(4096, 4096)), (0, 4096, 0, 4096, 0)),
    # Convolution's im2col: a shared weight times 64 patch matrices
    "im2col_shared_a": (lambda: (_f(256, 2304), _f(64, 2304, 900)),
                        (0, 2304, 0, 900, 2304 * 900)),
    "both_batched": (lambda: (_f(3, 130, 72), _f(3, 72, 52)), (0, 72, 130 * 72, 52, 72 * 52)),
    "batch_of_one_a": (lambda: (_f(1, 64, 64), _f(5, 64, 64)), (0, 64, 0, 64, 64 * 64)),
    "expanded_a": (lambda: (_f(64, 64).expand(5, 64, 64), _f(5, 64, 64)),
                   (0, 64, 0, 64, 64 * 64)),
    # K = 1: A's single column takes any 16-byte multiple as its stride
    "k_is_one": (lambda: (_f(257, 1), _f(1, 128)), (1, 260, 0, 128, 0)),
    "ragged_m": (lambda: (_f(132, 300), _f(300, 260)), (0, 300, 0, 260, 0)),
}


@pytest.mark.parametrize("case", sorted(TMA_CASES))
def test_route_sends_f32_operands_tma_reads_to_matmul_f32(case):
    make, operands = TMA_CASES[case]
    a, b = make()
    assert tmatmul._route(a, b) == "matmul_f32"
    assert tmatmul._f32_tma_operands(a, b) == operands


SIMT_CASES = {
    "b_row_stride_33": lambda: (_f(1, 256), _f(256, 33)),
    "a_row_stride_70": lambda: (_f(130, 70), _f(70, 52)),
    "tn_lead_130": lambda: (_f(72, 130).T, _f(72, 52)),  # a.T whose column stride is 130
    "a_base_off_16": lambda: (_off16(64, 64), _f(64, 64)),
    "b_base_off_16": lambda: (_f(64, 64), _off16(64, 64)),
    "column_major_b": lambda: (_f(64, 64), _f(72, 64).T),
    "odd_batch_stride": lambda: (
        _f(64, 64), _f(3 * 4097).as_strided((3, 64, 64), (4097, 64, 1))),
}


@pytest.mark.parametrize("case", sorted(SIMT_CASES))
def test_route_sends_other_f32_operands_to_the_simt_kernel(case):
    a, b = SIMT_CASES[case]()
    assert tmatmul._f32_tma_operands(a, b) is None
    assert tmatmul._route(a, b) == "matmul_f32_simt"


def test_route_still_refuses_what_no_f32_entry_takes():
    with pytest.raises(ValueError, match="row- or column-major"):
        tmatmul._route(_f(8, 16)[:, ::2], _f(8, 8))
    with pytest.raises(ValueError, match="batches differ"):
        tmatmul._route(_f(3, 4, 4), _f(2, 4, 4))
    with pytest.raises(ValueError, match="float32 or two bfloat16"):
        tmatmul._route(_f(4, 4), _f(4, 4).double())


@pytest.mark.parametrize("name", [
    "gemm_f32_nn", "gemm_f32_tn", "connected", "maxflops_f32", "convolution_im2col",
])
def test_the_paths_f32_products_route_to_the_tma_kernel(name, monkeypatch):
    """Every product the f32 rows hand the kernel route (preset 0, the same
    layouts as preset 4) is one the TMA kernel takes."""
    routes = []
    plain = tmatmul.matmul_plain

    def record(a, b):
        routes.append(tmatmul._route(a, b))
        return plain(a, b)

    monkeypatch.setattr(tmatmul, "matmul_plain", record)
    wl = get_benchmark(name).build_preset(0)
    bind_impl(wl.fn, wl, "kernel")(*wl.make_inputs(0))
    assert routes and set(routes) == {"matmul_f32"}


def test_tune_space_lists_each_compiled_f32_tile_default_first():
    space = ops.tune_space("matmul")
    assert space == ({"block_m": 128, "block_n": 128}, {"block_m": 128, "block_n": 256})
    assert space == tmatmul.F32_TILES
    assert space is not tmatmul.F32_TILES  # callers get their own copies


@pytest.mark.parametrize("operands,tile", [
    ((_f(64, 64), _f(64, 64)), (128, 192)),  # matmul_f32: not compiled
    ((_f(64, 64), _f(64, 64)), (256, 128)),
    ((_f(1, 256), _f(256, 33)), (128, 256)),  # matmul_f32_simt: 128 x 128 alone
    ((_f(64, 64).bfloat16(), _f(64, 64).bfloat16()), (128, 256)),  # matmul_bf16
    ((_f(3, 8, 8).bfloat16(), _f(3, 8, 8).bfloat16()), (128, 256)),  # matmul_bf16, batched
])
def test_a_tile_no_entry_compiles_raises_before_any_launch(operands, tile):
    a, b = operands
    launches = dict(tmatmul.launches)
    with pytest.raises(ValueError, match="no compiled tile"):
        tmatmul.matmul_cuda(a, b, block_m=tile[0], block_n=tile[1])
    assert tmatmul.launches == launches


def test_a_compiled_tile_reaches_the_device_check():
    """128 x 256 is compiled for matmul_f32: the call gets as far as the
    device check, which a CPU tensor fails."""
    with pytest.raises(ValueError, match="CUDA"):
        tmatmul.matmul_cuda(_f(64, 64), _f(64, 64), block_n=256)
    with pytest.raises(ValueError, match="CUDA"):
        tmatmul._launch("matmul_f32_simt", _f(64, 64), _f(64, 64))


@pytest.mark.parametrize("n", [1, tsort.TILE - 1, tsort.TILE, tsort.TILE + 1, 2**24,
                               2**31 - 1])
def test_sort_scratch_sizes(n):
    tiles = -(-n // 4096)
    assert tsort.TILE == 4096
    assert tsort.scratch_bytes(n) == {
        "status": tiles * 256 * 8,  # a 64-bit word per digit per tile, one array
        "histogram": 4 * 256 * 4,   # four passes' 256 counts
        "counters": 4 * 4,          # a tile counter per pass
    }


def test_sort_scratch_at_the_largest_length_fits_the_c_entrys_int():
    """radix_sort_scratch_bytes returns an int: at MAX_N = 2^31 - 1 keys the
    scratch is 1 GiB and 4112 bytes, below 2^31."""
    assert sum(tsort.scratch_bytes(tsort.MAX_N).values()) == 2**30 + 4112
    assert sum(tsort.scratch_bytes(tsort.MAX_N).values()) < 2**31
