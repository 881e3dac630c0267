"""The row softmax's and the LRN's routing between their register kernels
(``softmax_f32``/``softmax_bf16``, ``lrn_f32``) and the kernels those
replaced (``*_online``, ``lrn_f32_smem``), and the register kernels'
arithmetic, on the CPU.

Routing is pure Python over dtype, shapes, strides, addresses and the LRN
window, so it runs here without a card (large shapes as meta tensors,
whose address is 0). The plain PyTorch models of the new kernels'
arithmetic (``softmax_model``: an exact max, then one exponential;
``lrn_model``: ``x * 2^(-beta * log2 d)`` for the oracle's pow and division)
are held against the reference's Pallas kernels in interpret mode at the
reference's tolerances. The kernels themselves are held against their plain
versions in ``tests/test_torch_cuda.py`` (on a card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lrn import lrn_pallas
from repro.kernels.softmax import softmax_pallas
from repro_torch.core.registry import get_benchmark
from repro_torch.kernels import lrn as tlrn
from repro_torch.kernels import softmax as tsoftmax

F32, BF16 = torch.float32, torch.bfloat16


def _meta(*shape, dtype=F32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _off(n_before: int, *shape, dtype=F32):
    """A contiguous tensor that starts ``n_before`` elements into its
    storage (a base 16-byte aligned, so off it for n_before * size % 16)."""
    numel = int(np.prod(shape))
    base = torch.empty(n_before + numel, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[n_before:].view(*shape)


# ------------------------------------------------------------------ softmax

SOFTMAX_ROUTES = {
    # the register entries: whole 16-byte vectors, C up to MAX_COLS
    "f32_c8": (lambda: torch.empty(1, 8), "softmax_f32"),
    "f32_c64": (lambda: torch.empty(64, 64), "softmax_f32"),
    "f32_c4_rank3": (lambda: torch.empty(2, 3, 4), "softmax_f32"),
    "f32_widest": (lambda: _meta(4, tsoftmax.MAX_COLS), "softmax_f32"),
    "f32_rows_16_byte_stride": (lambda: torch.empty(6, 1028)[:, :1024], "softmax_f32"),
    "f32_one_row_any_stride": (lambda: torch.empty(1, 1025)[:, :1024], "softmax_f32"),
    "bf16_c8": (lambda: torch.empty(3, 8, dtype=BF16), "softmax_bf16"),
    "bf16_widest": (lambda: _meta(2, tsoftmax.MAX_COLS, dtype=BF16), "softmax_bf16"),
    "empty": (lambda: torch.empty(0, 7), "softmax_f32"),
    # the online entries: everything else
    "f32_c1": (lambda: torch.empty(37, 1), "softmax_f32_online"),
    "f32_c_not_whole_vectors": (lambda: torch.empty(7, 1031), "softmax_f32_online"),
    "f32_above_register_limit": (lambda: _meta(3, tsoftmax.MAX_COLS + 4), "softmax_f32_online"),
    "f32_base_off_16": (lambda: _off(1, 4, 64), "softmax_f32_online"),
    "f32_row_stride_off_16": (lambda: torch.empty(6, 1025)[:, :1024], "softmax_f32_online"),
    "bf16_c4": (lambda: torch.empty(5, 4, dtype=BF16), "softmax_bf16_online"),
    "bf16_c12": (lambda: torch.empty(5, 12, dtype=BF16), "softmax_bf16_online"),
    "bf16_base_off_16": (lambda: _off(4, 4, 64, dtype=BF16), "softmax_bf16_online"),
    "bf16_above_register_limit": (
        lambda: _meta(2, tsoftmax.MAX_COLS + 8, dtype=BF16), "softmax_bf16_online"),
}


@pytest.mark.parametrize("case", sorted(SOFTMAX_ROUTES))
def test_softmax_route_picks_the_entry_for_the_layout(case):
    make, entry = SOFTMAX_ROUTES[case]
    assert tsoftmax._route(make()) == entry


@pytest.mark.parametrize("preset", range(5))
def test_softmax_presets_route_to_the_register_kernel(preset):
    size = get_benchmark("softmax").presets[preset]
    x = _meta(size["batch"], size["classes"])  # as make_inputs lays it out
    assert tsoftmax._route(x) == "softmax_f32"


@pytest.mark.parametrize("make,match", [
    (lambda: torch.empty(4, 8, dtype=torch.float16), "float32 or bfloat16"),
    (lambda: torch.empty(4, 8, dtype=torch.float64), "float32 or bfloat16"),
    (lambda: torch.tensor(1.0), "at least one axis"),
    (lambda: torch.empty(8, 8).T, "unit stride"),
    (lambda: torch.empty(8, 16)[:, ::2], "unit stride"),
    (lambda: torch.empty(4, 6, 8).transpose(0, 1), "cannot view"),
], ids=["f16", "f64", "scalar", "transposed", "column_step", "not_rows"])
def test_softmax_route_refuses_what_no_entry_takes(make, match):
    with pytest.raises(ValueError, match=match):
        tsoftmax._route(make())
    # ... on the CUDA entry too, before it looks at the device.
    with pytest.raises(ValueError, match=match):
        tsoftmax.softmax_cuda(make())


def test_softmax_launch_refuses_an_entry_that_does_not_take_the_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        tsoftmax._launch("softmax_f32", torch.empty(4, 8))
    assert tsoftmax._ANY_LAYOUT == {F32: "softmax_f32_online", BF16: "softmax_bf16_online"}


SOFTMAX_MODEL_SHAPES = [(1, 8), (33, 257), (64, 64), (7, 1031), (4, 4096)]


@pytest.mark.parametrize("rows,cols", SOFTMAX_MODEL_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("scale", [5.0, 80.0])
def test_softmax_model_matches_pallas(rng, rows, cols, dtype, scale):
    """The register kernel's arithmetic (exact max, one exponential an
    element) against the reference's online two-pass kernel."""
    x = (scale * jnp.asarray(rng.normal(size=(rows, cols)).astype(np.float32))).astype(dtype)
    want = np.asarray(softmax_pallas(x, block_rows=16, block_cols=64, interpret=True),
                      np.float32)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        F32 if dtype == np.float32 else BF16)
    got = tsoftmax.softmax_model(tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    # Relative only, as the reference's tolerance is for these outputs.
    tol = 1e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=1e-30)


def test_softmax_model_keeps_the_references_constants():
    # Rows of equal values and a row far below zero: the max from -1e30,
    # the sum from max(l, 1e-30).
    x = torch.tensor([[3.25] * 8, [-1e31] * 8])
    got = tsoftmax.softmax_model(x)
    torch.testing.assert_close(got[0], torch.full((8,), 0.125))
    torch.testing.assert_close(got[1], torch.zeros(8))


# ---------------------------------------------------------------------- LRN

LRN_ROUTES = {
    # the ring kernel: sizes 3 and 5, S % 4 == 0, a 16-byte aligned base
    "size3": (lambda: torch.empty(2, 64, 8, 8), 3, "lrn_f32"),
    "size5": (lambda: torch.empty(2, 64, 8, 8), 5, "lrn_f32"),
    "c_off_the_chunk": (lambda: torch.empty(3, 45, 8, 8), 5, "lrn_f32"),
    "s_is_4": (lambda: torch.empty(2, 7, 2, 2), 3, "lrn_f32"),
    "largest_grid": (lambda: _meta(tlrn.MAX_N, 8, 4, 4), 5, "lrn_f32"),
    # the shared-memory kernel: the rest
    "size1": (lambda: torch.empty(2, 64, 8, 8), 1, "lrn_f32_smem"),
    "size7": (lambda: torch.empty(3, 45, 8, 8), 7, "lrn_f32_smem"),
    "size65": (lambda: torch.empty(2, 100, 5, 7), 65, "lrn_f32_smem"),
    "s_not_4": (lambda: torch.empty(2, 13, 9, 11), 5, "lrn_f32_smem"),
    "s_is_6": (lambda: torch.empty(2, 13, 2, 3), 3, "lrn_f32_smem"),
    "base_off_16": (lambda: _off(1, 2, 40, 4, 4), 5, "lrn_f32_smem"),
    "base_off_8": (lambda: _off(2, 2, 40, 4, 4), 3, "lrn_f32_smem"),
}


@pytest.mark.parametrize("case", sorted(LRN_ROUTES))
def test_lrn_route_picks_the_entry_for_the_layout(case):
    make, size, entry = LRN_ROUTES[case]
    assert tlrn._route(make(), size) == entry


@pytest.mark.parametrize("preset", range(5))
def test_lrn_presets_route_to_the_ring_kernel(preset):
    p = get_benchmark("lrn").presets[preset]
    x = _meta(p["n"], p["c"], p["hw"], p["hw"])
    assert tlrn._route(x, 5) == "lrn_f32"  # the benchmark's size


@pytest.mark.parametrize("make,size,match", [
    (lambda: torch.empty(2, 8, 4, 4, dtype=torch.float64), 5, "float32"),
    (lambda: torch.empty(2, 8, 4, 4, dtype=BF16), 5, "float32"),
    (lambda: torch.empty(8, 4, 4), 5, r"\(N, C, H, W\)"),
    (lambda: torch.empty(2, 8, 4, 4).transpose(2, 3), 5, "contiguous"),
    (lambda: torch.empty(2, 8, 4, 4), 4, "odd window size"),
    (lambda: torch.empty(2, 8, 4, 4), 0, "odd window size"),
    (lambda: torch.empty(2, 8, 4, 4), 67, "size <= 65"),
    (lambda: _meta(tlrn.MAX_N + 1, 8, 4, 4), 5, "at most"),
    (lambda: _meta(1, tlrn.MAX_C + 1, 1, 4), 5, "at most"),
], ids=["f64", "bf16", "rank3", "strided", "even", "zero", "too_wide", "images", "channels"])
def test_lrn_route_refuses_what_no_entry_takes(make, size, match):
    with pytest.raises(ValueError, match=match):
        tlrn._route(make(), size)
    with pytest.raises(ValueError, match=match):
        tlrn.lrn_cuda(make(), size=size)


def test_lrn_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tlrn._launch("lrn_f32", torch.empty(2, 8, 4, 4))


LRN_MODEL_SHAPES = [(1, 5, 4, 4), (2, 13, 9, 11), (3, 64, 8, 8), (3, 45, 8, 8)]


@pytest.mark.parametrize("shape", LRN_MODEL_SHAPES)
@pytest.mark.parametrize("size,alpha,beta,k", [
    (5, 1e-4, 0.75, 2.0), (3, 1e-4, 0.75, 2.0), (3, 0.5, 0.5, 1.0), (5, 1.0, 0.75, 1.0),
])
def test_lrn_model_matches_pallas(rng, shape, size, alpha, beta, k):
    """The ring kernel's arithmetic (the oracle's window sum, then x *
    2^(-beta * log2 d)) against the reference's band-matrix kernel."""
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(lrn_pallas(jnp.asarray(x), size=size, alpha=alpha, beta=beta, k=k,
                                 block_s=16, interpret=True))
    got = tlrn.lrn_model(torch.from_numpy(x), size=size, alpha=alpha, beta=beta, k=k)
    assert got.dtype == F32 and tuple(got.shape) == shape
    # tests/test_kernels_misc.py:35
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size", [3, 5])
def test_lrn_model_keeps_the_oracles_window_sum(rng, size):
    """Only the power differs from the oracle: with beta = 1 and k = 0 both
    reduce to x / (alpha * win) up to the last rounding."""
    x = torch.from_numpy(rng.normal(size=(2, 40, 4, 4)).astype(np.float32))
    got = tlrn.lrn_model(x, size=size, alpha=1.0, beta=1.0, k=0.0)
    want = tlrn.lrn_plain(x, size=size, alpha=1.0, beta=1.0, k=0.0)
    torch.testing.assert_close(got, want, rtol=4e-7, atol=0.0)
