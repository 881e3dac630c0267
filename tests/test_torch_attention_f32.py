"""The f32 attention entries and the fused decode's bookkeeping, on the CPU.

- ``_route`` sends f32 whose q, k and v TMA can read to
  ``flash_attention_f32`` (``csrc/flash_attention_f32_tma.cu``) and every
  other f32 view to ``flash_attention_f32_simt``; the bf16 routes stay.
- ``launches`` names exactly the C entry points the attention sources
  export.
- The decode kernel's counters and scratch: sized per call, kept per
  (device, stream), grown and never shrunk.
- The kernel route (which runs the plain version for CPU tensors) against
  the reference's ``flash_attention_pallas`` in interpret mode, as its own
  tests run it, at the new kernel's tile edges (64-key tiles, 16-row warps,
  128-row CTAs): S and T off multiples of the tile, windows, D from 8 to
  128 and groups from 1 to 8, inputs from a numpy seed, tolerance 2e-4
  (tests/test_kernels_attention.py:39).

The kernels themselves run only on a card (``test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.convert import from_reference
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as tfa


def _f32(*shape):
    return torch.empty(*shape, dtype=torch.float32)


def _odd(shape, dtype=torch.float32):
    """A view of ``shape`` one element into its storage (base off 16 bytes)."""
    n = int(np.prod(shape))
    return torch.empty(n + 1, dtype=dtype)[1:].view(*shape)


def test_route_sends_aligned_f32_to_the_tma_kernel():
    q, kv = _f32(8, 32, 1024, 128), _f32(8, 8, 1024, 128)
    assert tfa._route(q, kv, kv) == "flash_attention_f32"
    # The model's views: (B, T, H, D) activations, a cache sliced to kv_len.
    cache = _f32(4, 64, 2, 16)
    qv = _f32(4, 16, 4, 16).transpose(1, 2)
    assert tfa._route(qv, cache[:, :16].transpose(1, 2),
                      cache[:, :16].transpose(1, 2)) == "flash_attention_f32"
    step = _f32(4, 1, 4, 16).transpose(1, 2)
    assert tfa._route(step, cache[:, :32].transpose(1, 2),
                      cache[:, :32].transpose(1, 2)) == "flash_attention_f32"
    tma_dims = tfa.ENTRY_HEAD_DIMS["flash_attention_f32"]
    for d in tfa.HEAD_DIMS:  # every compiled head dim, prefill and decode rows
        want = "flash_attention_f32" if d in tma_dims else "flash_attention_f32_simt"
        for t in (1, 40):
            assert tfa._route(_f32(1, 4, t, d), _f32(1, 2, 70, d), _f32(1, 2, 70, d)) == want
    # D = 80 (hubert-xlarge's) is compiled by the SIMT kernels alone.
    assert 80 not in tfa.ENTRY_HEAD_DIMS["flash_attention_f32"]
    assert 80 in tfa.ENTRY_HEAD_DIMS["flash_attention_f32_simt"]


def test_route_keeps_the_simt_kernel_for_f32_views_tma_cannot_read():
    q, kv = _f32(1, 4, 8, 16), _f32(1, 2, 40, 16)
    odd = _odd((1, 2, 40, 16))
    assert odd.data_ptr() % 16 != 0
    assert tfa._route(q, odd, odd) == "flash_attention_f32_simt"
    assert tfa._route(_odd((1, 4, 8, 16)), kv, kv) == "flash_attention_f32_simt"
    # A key stride of 18 floats (72 bytes): rows off 16 bytes.
    ragged = _f32(1, 2, 40, 18)[..., :16]
    assert ragged.stride(2) * 4 % 16 != 0
    assert tfa._route(q, ragged, ragged) == "flash_attention_f32_simt"
    # An expanded (stride 0) head axis: a tensor map's strides are positive.
    spread = _f32(1, 1, 40, 16).expand(1, 2, 40, 16)
    assert tfa._route(q, spread, spread) == "flash_attention_f32_simt"
    # The same axis of one entry has no stride to speak of.
    one = _f32(1, 1, 40, 16)
    assert tfa._route(_f32(1, 4, 8, 16), one, one) == "flash_attention_f32"
    # bf16 routes as before: the SIMT kernel keeps what TMA cannot read.
    bodd = _odd((1, 2, 64, 128), torch.bfloat16)
    assert tfa._route(torch.empty(1, 4, 1, 128, dtype=torch.bfloat16), bodd,
                      bodd) == "flash_attention_bf16_simt"


def test_launch_takes_the_simt_entry_of_either_dtype_and_refuses_the_rest():
    q, kv = _f32(1, 4, 8, 16), _f32(1, 2, 40, 16)
    for name in ("flash_attention_bf16_wgmma", "flash_decode_bf16", "flash_attention_bf16_simt"):
        with pytest.raises(ValueError, match="does not take"):
            tfa._launch(name, q, kv, kv)
    launches = dict(tfa.launches)
    for name in ("flash_attention_f32", "flash_attention_f32_simt"):
        with pytest.raises(ValueError, match="CUDA"):  # taken, but refused on the CPU
            tfa._launch(name, q, kv, kv)
    assert tfa.launches == launches


def _c_entries() -> set[str]:
    names = set()
    for src in ("flash_attention.cu", "flash_attention_wgmma.cu", "flash_decode.cu",
                "flash_attention_f32_tma.cu"):
        text = (_build.SOURCES_DIR / src).read_text()
        names |= set(re.findall(r'extern "C" int (\w+)\(', text))
    return {n for n in names if not n.endswith("_smem_bytes")}


def test_launch_counters_name_exactly_the_entries_that_exist():
    assert set(tfa.launches) == _c_entries() == {
        "flash_attention_f32", "flash_attention_f32_simt", "flash_attention_bf16_simt",
        "flash_attention_bf16_wgmma", "flash_decode_bf16",
    }
    assert not hasattr(tfa, "flash_decode_combine_cuda")


@pytest.mark.parametrize("b,hq,hkv,t,d,splits,want", [
    (8, 32, 8, 1, 128, 5, (64, 8 * 32 * 5 * 130)),  # the serving path's decode step
    (8, 32, 8, 1, 128, 1, (0, 0)),                  # one split: no scratch, no counter
    (2, 8, 2, 4, 64, 3, (4, 2 * 8 * 4 * 3 * 66)),
])
def test_decode_scratch_sizes(b, hq, hkv, t, d, splits, want):
    assert tfa.decode_scratch_sizes(b, hq, hkv, t, d, splits) == want


def test_decode_scratch_is_kept_per_device_and_stream_and_grows():
    cache = tfa.DecodeScratch()
    cpu = torch.device("cpu")
    assert cache.counters(cpu, 7) is None
    cnt, part = cache.get(cpu, 7, 64, 1000)
    assert cnt.dtype == torch.int32 and cnt.numel() == 64 and not cnt.any()
    assert part.dtype == torch.float32 and part.numel() == 1000
    # The same stream again, needing no more: the same buffers.
    again = cache.get(cpu, 7, 32, 500)
    assert again[0] is cnt and again[1] is part
    assert cache.counters(cpu, 7) is cnt
    # Another stream: its own pair, never the first stream's.
    other = cache.get(cpu, 8, 64, 1000)
    assert other[0] is not cnt and other[1] is not part
    # Growing one buffer keeps the other; the new counters are zeros.
    grown = cache.get(cpu, 7, 128, 800)
    assert grown[0].numel() == 128 and not grown[0].any() and grown[1] is part
    grown2 = cache.get(cpu, 7, 16, 4000)
    assert grown2[0] is grown[0] and grown2[1].numel() == 4000
    assert cache.counters(cpu, 8) is other[0]


def test_the_module_keeps_one_scratch_cache():
    assert isinstance(tfa.scratch, tfa.DecodeScratch)


def test_combine_plain_sums_in_split_order_one_rounding_at_a_time(rng):
    """The merge the kernel's epilogue reproduces: split-order sums of
    separately rounded products, against a float64 evaluation of the same
    formula, and one split returning the partial itself."""
    b, hkv, splits, rows, d = 2, 2, 5, 4, 16
    part_o = torch.from_numpy(rng.normal(size=(b, hkv, splits, rows, d)).astype(np.float32))
    m = rng.normal(size=(b, hkv, splits, rows)).astype(np.float32) * 4
    m[0, 0, 2] = -1e30  # a split that saw no key
    lsum = rng.uniform(0.5, 3, size=(b, hkv, splits, rows)).astype(np.float32)
    lsum[0, 0, 2] = 0
    part_o[0, 0, 2] = 0
    part_ml = torch.from_numpy(np.stack([m, lsum], -1))
    got = tfa.flash_decode_combine_plain(part_o, part_ml, hq=8, t=1, dtype=torch.float32)
    w = np.exp2(m.astype(np.float64) - m.max(2, keepdims=True))
    want = ((part_o.double().numpy() * w[..., None]).sum(2)
            / (lsum * w).sum(2)[..., None])
    want = want.reshape(b, hkv, 1, 4, d).transpose(0, 1, 3, 2, 4).reshape(b, 8, 1, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    one = tfa.flash_decode_combine_plain(part_o[:, :, :1], part_ml[:, :, :1], hq=8, t=1,
                                         dtype=torch.float32)
    direct = part_o[:, :, 0] / part_ml[:, :, 0, :, 1].clamp_min(1e-30)[..., None]
    torch.testing.assert_close(
        one, direct.reshape(b, hkv, 1, 4, d).transpose(2, 3).reshape(b, 8, 1, d),
        rtol=0, atol=0)


# The new kernel's tile edges: B, Hq, Hkv, T, S, D, causal, window. S and T
# one short of and one past the 64-key tile, rows per KV head one past a
# 16-row warp and a 128-row CTA (the decode variant at <= 16), windows
# narrower than a tile and across tiles, D from 8 to 128, groups 1 to 8.
F32_EDGE_CASES = [
    (1, 1, 1, 63, 63, 8, True, None),
    (1, 2, 1, 65, 65, 16, True, None),
    (1, 8, 1, 17, 129, 32, True, 40),
    (1, 4, 1, 33, 127, 64, False, None),
    (1, 8, 2, 1, 65, 128, False, None),
    (2, 8, 8, 1, 200, 16, True, 70),
    (1, 4, 4, 129, 129, 8, True, 64),
    (1, 6, 2, 7, 70, 32, True, None),
    (1, 4, 1, 5, 64, 128, True, 3),
    (2, 3, 1, 11, 90, 64, False, 30),
]


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,window", F32_EDGE_CASES)
def test_f32_kernel_route_matches_reference_at_the_tile_edges(
        rng, b, hq, hkv, t, s, d, causal, window):
    q = rng.normal(size=(b, hq, t, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window, block_q=64, block_k=64,
                                  interpret=True)
    tq, tk, tv = from_reference([q, k, v], "cpu")
    assert tfa._route(tq, tk, tv, window) == "flash_attention_f32"
    plain = tfa.plain_calls
    got = ops.attention(tq, tk, tv, causal=causal, window=window, mode="kernel")
    assert tfa.plain_calls == plain + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, hq, t, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
