"""The port's attention kernel route against the reference's flash kernel, on
the CPU.

The same numpy-seeded inputs go through the reference's
``flash_attention_pallas`` (interpret mode, as its own tests run it) and
through the port's kernel route, which runs the plain version for CPU
tensors, at the reference's cases and tolerances
(tests/test_kernels_attention.py: 2e-4 for f32, 2e-2 for bf16). The CUDA
kernel itself runs only on a card: ``chip_smoke.py`` and
``test_torch_cuda.py`` hold it against this plain version there. The
wrapper's checks, which run before any launch, are tested here.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.layers import sdpa
from repro_torch.convert import from_reference
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops

# tests/test_kernels_attention.py:19-27 — B, Hq, Hkv, T, S, D, causal, window
CASES = [
    (1, 2, 2, 32, 32, 16, False, None),
    (2, 4, 2, 32, 32, 16, True, None),
    (1, 8, 1, 17, 17, 8, True, None),
    (2, 4, 4, 33, 33, 16, True, 9),
    (1, 4, 2, 1, 64, 16, True, None),
    (1, 4, 2, 1, 64, 16, True, 17),
    (2, 2, 2, 16, 48, 8, True, None),
]
# A window wider than the offset (S - T = 32 < 40) and a non-causal window.
MORE = [
    (1, 4, 1, 16, 48, 32, True, 40),
    (1, 4, 4, 24, 24, 16, False, 7),
]


def _qkv(rng, b, hq, hkv, t, s, d):
    return (rng.normal(size=(b, hq, t, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,window", CASES + MORE)
def test_kernel_route_matches_reference_flash_kernel(rng, b, hq, hkv, t, s, d, causal, window):
    q, k, v = _qkv(rng, b, hq, hkv, t, s, d)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window, block_q=16, block_k=16,
                                  interpret=True)
    plain = tfa.plain_calls
    got = ops.attention(*from_reference([q, k, v], "cpu"), causal=causal, window=window,
                        mode="kernel")
    assert tfa.plain_calls == plain + 1  # the kernel route ran its plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, hq, t, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_kernel_route_bf16_matches_reference(rng):
    q, k, v = _qkv(rng, 1, 2, 2, 32, 32, 16)
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    kernel = flash_attention_pallas(qb, kb, vb, causal=True, block_q=16, block_k=16,
                                    interpret=True)
    got = tfa.flash_attention_kernel(
        *from_reference([np.asarray(x) for x in (qb, kb, vb)], "cpu"), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(kernel, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_route_takes_the_models_views(rng, causal):
    """Transposed (B, T, H, D) activations and a cache sliced to kv_len < S
    give what the same call gives on contiguous copies."""
    b, hq, hkv, t, s_len, kv_len, d = 2, 8, 2, 5, 40, 29, 16
    q = torch.from_numpy(rng.normal(size=(b, t, hq, d)).astype(np.float32)).transpose(1, 2)
    kc, vc = (torch.from_numpy(rng.normal(size=(b, s_len, hkv, d)).astype(np.float32))
              for _ in range(2))
    k, v = kc[:, :kv_len].transpose(1, 2), vc[:, :kv_len].transpose(1, 2)
    assert not (q.is_contiguous() or k.is_contiguous())
    got = tfa.flash_attention_kernel(q, k, v, causal=causal)
    want = tfa.flash_attention_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                                      causal=causal)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    ref = flash_attention_pallas(jnp.asarray(q.contiguous().numpy()),
                                 jnp.asarray(k.contiguous().numpy()),
                                 jnp.asarray(v.contiguous().numpy()), causal=causal,
                                 block_q=8, block_k=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_port_attention_equals_reference_model_sdpa(rng):
    """tests/test_kernels_attention.py:52 for the port: its attention op and
    the reference's model-layer sdpa agree at 2e-4."""
    q, k, v = _qkv(rng, 2, 4, 2, 24, 24, 16)
    got = ops.attention(*from_reference([q, k, v], "cpu"), causal=True, window=7,
                        mode="kernel")
    want = sdpa(*(jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v)),
                causal=True, window=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.swapaxes(want, 1, 2)),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("d", [4, 12, 96, 256])
def test_launcher_refuses_head_dims_it_does_not_compile(d):
    q = torch.ones(1, 2, 4, d)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_cuda(q, q, q)


def test_launcher_refuses_layouts_before_any_launch():
    q = torch.ones(1, 4, 3, 16)
    k = torch.ones(1, 2, 5, 32)[..., ::2]  # shape (1, 2, 5, 16), last stride 2
    with pytest.raises(ValueError, match="unit stride"):
        tfa.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_attention_cuda(q, torch.ones(1, 3, 5, 16), torch.ones(1, 3, 5, 16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention_cuda(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="do not match"):
        tfa.flash_attention_cuda(q, torch.ones(1, 2, 5, 16), torch.ones(1, 2, 6, 16))
    with pytest.raises(ValueError, match="compiled tile"):
        tfa.flash_attention_cuda(q, q, q, block_q=32)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention_cuda(q, q, q, window=-1)
    # A layout it takes, on the CPU: refused for the device, not run.
    launches = dict(tfa.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, torch.ones(1, 2, 5, 16), torch.ones(1, 2, 5, 16))
    assert tfa.launches == launches


def test_attention_is_a_kernel_op_with_one_compiled_tile():
    # The tile the op's block parameters name is the wgmma prefill kernel's:
    # 128 packed rows (two warpgroups of 64), 128 keys a tile.
    assert ops.KERNEL_OPS["attention"] is tfa
    assert ops.tune_space("attention") == ({"block_q": 128, "block_k": 128},)
    with pytest.raises(KeyError, match="unknown kernel op"):
        ops.tune_space("flash")


# Decode-shaped cases (at most 16 packed rows per KV head): B, Hq, Hkv, T, S,
# D, causal, window. Windows that leave the first splits without a visible
# key for some rows (T > 1), S below one tile, and a cache of many tiles.
DECODE_CASES = [
    (1, 4, 2, 1, 64, 16, True, None),
    (1, 4, 2, 1, 64, 16, True, 17),
    (2, 8, 2, 1, 300, 32, False, None),
    (1, 4, 1, 4, 200, 16, True, 70),
    (1, 8, 2, 2, 260, 16, False, 100),
    (2, 4, 4, 1, 40, 16, True, None),
]


def _decode_params():
    out = []
    for case in DECODE_CASES:
        _, hq, hkv, t, s, _, causal, window = case
        lo, hi = tfa.decode_tiles(t, s, hq // hkv, causal, window)
        for splits in sorted({1, 2, 3, hi - lo, hi - lo + 1, hi - lo + 3} - {0}):
            out.append((*case, splits))
    return out


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,window,splits", _decode_params())
def test_flash_decode_plain_matches_reference_at_every_split_count(
        rng, b, hq, hkv, t, s, d, causal, window, splits):
    """The decode kernel's split-and-merge, in plain PyTorch, against the
    reference's flash kernel (interpret mode), from one split to more splits
    than visible tiles."""
    q, k, v = _qkv(rng, b, hq, hkv, t, s, d)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window, block_q=16, block_k=16,
                                  interpret=True)
    tq, tk, tv = from_reference([q, k, v], "cpu")
    got = tfa.flash_decode_plain(tq, tk, tv, causal=causal, window=window, splits=splits)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, hq, t, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    lo, hi = tfa.decode_tiles(t, s, hq // hkv, causal, window)
    _, part_ml = tfa.flash_decode_partials_plain(tq, tk, tv, causal=causal, window=window,
                                                 splits=splits)
    # With more splits than visible tiles some get none: m = -1e30, l = 0.
    empty = [i for i in range(splits) if len(set(tfa._split_bounds(lo, hi, splits, i))) == 1]
    assert len(empty) == max(splits - (hi - lo), 0)
    for i in empty:
        assert bool((part_ml[:, :, i, :, 0] == -1e30).all())
        assert bool((part_ml[:, :, i, :, 1] == 0).all())


def test_flash_decode_plain_bf16_matches_reference(rng):
    q, k, v = _qkv(rng, 2, 32, 8, 1, 300, 128)
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tfa.flash_decode_plain(*from_reference([np.asarray(x) for x in (qb, kb, vb)], "cpu"),
                                 splits=3)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("b,hkv,s", [(8, 8, 1088), (8, 8, 1025), (1, 8, 1088), (2, 1, 200),
                                     (32, 8, 1088), (8, 8, 40), (64, 8, 2048)])
def test_decode_splits_fill_two_waves_with_a_tile_each(b, hkv, s):
    """Enough splits for 2 x 132 CTAs where the tiles allow it, and never a
    split without a tile."""
    lo, hi = tfa.decode_tiles(1, s, 4, False, None)
    n = hi - lo
    splits = tfa.decode_splits(b, hkv, n)
    assert 1 <= splits <= max(n, 1)
    assert b * hkv * splits >= 2 * 132 or splits == n
    assert all(te > tb for tb, te in (tfa._split_bounds(lo, hi, splits, i)
                                      for i in range(splits)))
    if (b, hkv, s) == (8, 8, 1088):  # the serving path's decode step
        assert (n, splits, b * hkv * splits) == (17, 5, 320)


def _bf16(*shape):
    return torch.empty(*shape, dtype=torch.bfloat16)


def test_route_sends_the_paths_shapes_to_the_new_entries():
    # Prefill and decode of granite-3-8b at batch 8, contiguous and as the
    # model's views (transposed activations, a cache sliced to kv_len).
    q, kv = _bf16(8, 32, 1024, 128), _bf16(8, 8, 1024, 128)
    assert tfa._route(q, kv, kv) == "flash_attention_bf16_wgmma"
    assert tfa._route(_bf16(8, 32, 1, 128), _bf16(8, 8, 1088, 128),
                      _bf16(8, 8, 1088, 128)) == "flash_decode_bf16"
    cache = _bf16(8, 1096, 8, 128)
    qv = _bf16(8, 1024, 32, 128).transpose(1, 2)
    assert tfa._route(qv, cache[:, :1024].transpose(1, 2),
                      cache[:, :1024].transpose(1, 2)) == "flash_attention_bf16_wgmma"
    step = _bf16(8, 1, 32, 128).transpose(1, 2)
    assert tfa._route(step, cache[:, :1025].transpose(1, 2),
                      cache[:, :1025].transpose(1, 2), None) == "flash_decode_bf16"
    assert tfa._route(q.float(), kv.float(), kv.float()) == "flash_attention_f32"
    # The f32 smoke LM's prefill and decode views (granite-3-8b smoke: heads
    # 4/2, head_dim 16, a cache of 64) go to the TMA kernel as well; the same
    # cache one float into its storage goes to the SIMT kernel.
    cache = torch.empty(4, 64, 2, 16)
    odd = torch.empty(1 + 4 * 64 * 2 * 16)[1:].view(4, 64, 2, 16)
    for t, kv_len in ((16, 16), (1, 32)):
        qv = torch.empty(4, t, 4, 16).transpose(1, 2)
        assert tfa._route(qv, cache[:, :kv_len].transpose(1, 2),
                          cache[:, :kv_len].transpose(1, 2)) == "flash_attention_f32"
        assert tfa._route(qv, odd[:, :kv_len].transpose(1, 2),
                          odd[:, :kv_len].transpose(1, 2)) == "flash_attention_f32_simt"


def test_route_keeps_the_simt_kernel_for_what_the_new_entries_do_not_take():
    q, kv = _bf16(1, 4, 1, 128), _bf16(1, 2, 64, 128)
    odd = _bf16(1 + 2 * 64 * 128)[1:].view(1, 2, 64, 128)  # one element into its storage
    assert odd.data_ptr() % 16 != 0
    assert tfa._route(q, odd, odd) == "flash_attention_bf16_simt"
    assert tfa._route(_bf16(1, 4, 64, 128), odd, odd) == "flash_attention_bf16_simt"
    assert tfa._route(_bf16(1, 4, 1, 16), _bf16(1, 2, 64, 16),
                      _bf16(1, 2, 64, 16)) == "flash_attention_bf16_simt"  # D = 16
    one = _bf16(1, 1, 64, 128)
    assert tfa._route(_bf16(1, 4, 5, 128), one, one) == "flash_attention_bf16_simt"  # 20 rows
    # Group 6 is the wgmma entry's since it takes any group up to 128; a
    # group over 128 stays here.
    assert tfa._route(_bf16(1, 6, 32, 64), _bf16(1, 1, 64, 64),
                      _bf16(1, 1, 64, 64)) == "flash_attention_bf16_wgmma"  # group 6
    assert tfa._route(_bf16(1, 129, 1, 64), _bf16(1, 1, 64, 64),
                      _bf16(1, 1, 64, 64)) == "flash_attention_bf16_simt"  # group 129
    assert tfa._route(q, kv, kv) == "flash_decode_bf16"


# (Hq, Hkv, T, S, D) of bf16 prefills the wgmma entry takes: groups that do
# not divide 128 at D 128 (a CTA holds group * floor(128 / group) packed
# rows), D 80 at groups 1 and 2, and the paths' shapes: qwen2-vl-2b's
# prefill (group 6), mixtral-8x22b's (group 6, one batch row) and
# hubert-xlarge's encoder layer (D 80).
WGMMA_PREFILLS = {
    "group3": (3, 1, 300, 300, 128), "group5": (15, 3, 77, 77, 128),
    "group6": (48, 8, 100, 100, 128), "group12": (24, 2, 100, 160, 128),
    "group48": (48, 1, 33, 33, 128), "group128": (128, 1, 1, 70, 128),
    "d80-group1": (16, 16, 64, 64, 80), "d80-group2": (4, 2, 45, 77, 80),
    "qwen2-vl-2b": (12, 2, 2048, 2048, 128), "mixtral-8x22b": (48, 8, 6144, 6144, 128),
    "hubert-xlarge": (16, 16, 4096, 4096, 80),
}


@pytest.mark.parametrize("case", WGMMA_PREFILLS, ids=list(WGMMA_PREFILLS))
def test_route_sends_any_group_up_to_128_and_head_dim_80_to_the_wgmma_entry(case):
    hq, hkv, t, s, d = WGMMA_PREFILLS[case]
    q, kv = _bf16(1, hq, t, d), _bf16(1, hkv, s, d)
    assert tfa._route(q, kv, kv) == "flash_attention_bf16_wgmma"
    assert d in tfa.ENTRY_HEAD_DIMS["flash_attention_bf16_wgmma"]
    # The same operands as the model's views: transposed activations and a
    # cache sliced to S.
    qv = _bf16(1, t, hq, d).transpose(1, 2)
    cache = _bf16(1, s + 8, hkv, d)[:, :s].transpose(1, 2)
    assert tfa._route(qv, cache, cache, 4096) == "flash_attention_bf16_wgmma"


# bf16 calls the SIMT entry keeps: D 16, 20 packed rows (17-63 are neither
# decode's nor wgmma's), q one element into its storage, k and v likewise,
# and D 80 below 64 packed rows.
SIMT_PREFILLS = {
    "d16": ((1, 4, 64, 16), (1, 2, 64, 16), 0),
    "20-rows": ((1, 4, 5, 128), (1, 1, 64, 128), 0),
    "20-rows-group5": ((1, 5, 4, 128), (1, 1, 64, 128), 0),
    "unaligned-q": ((1, 6, 64, 128), (1, 1, 64, 128), 1),
    "unaligned-kv": ((1, 6, 64, 128), (1, 1, 64, 128), 2),
    "d80-33-rows": ((1, 4, 33, 80), (1, 4, 33, 80), 0),
}


@pytest.mark.parametrize("case", SIMT_PREFILLS, ids=list(SIMT_PREFILLS))
def test_route_keeps_small_head_dims_few_rows_and_unaligned_views_on_simt(case):
    q_shape, kv_shape, odd = SIMT_PREFILLS[case]

    def make(shape, off):  # ``off`` elements into its storage
        n = int(np.prod(shape))
        return _bf16(n + off)[off:].view(*shape)

    q = make(q_shape, odd == 1)
    kv = make(kv_shape, odd == 2)
    assert tfa._route(q, kv, kv) == "flash_attention_bf16_simt"


def test_route_refuses_layouts_no_entry_takes():
    q = _bf16(1, 4, 1, 64)
    with pytest.raises(ValueError, match="unit stride"):
        tfa._route(q, _bf16(1, 2, 8, 128)[..., ::2], _bf16(1, 2, 8, 64))
    with pytest.raises(ValueError, match="head dim"):
        tfa._route(_bf16(1, 4, 1, 96), _bf16(1, 2, 8, 96), _bf16(1, 2, 8, 96))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa._route(q.half(), _bf16(1, 2, 8, 64).half(), _bf16(1, 2, 8, 64).half())
    launches = dict(tfa.launches)
    for fn in (tfa.flash_attention_cuda, tfa.flash_decode_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, _bf16(1, 2, 8, 64), _bf16(1, 2, 8, 64))
    with pytest.raises(ValueError, match="does not take"):
        tfa.flash_decode_partials_cuda(_bf16(1, 4, 64, 64), _bf16(1, 2, 64, 64),
                                       _bf16(1, 2, 64, 64), splits=2)
    assert tfa.launches == launches


# Each attention entry's source under kernels/csrc/.
SOURCES = {
    "flash_attention_f32": "flash_attention_f32_tma.cu",
    "flash_attention_f32_simt": "flash_attention.cu",
    "flash_attention_bf16_simt": "flash_attention.cu",
    "flash_attention_bf16_wgmma": "flash_attention_wgmma.cu",
    "flash_decode_bf16": "flash_decode.cu",
}


def _switch_cases(source: str) -> list[set[int]]:
    """The head dims of every ``switch (D)`` in a kernel source: one set of
    ``case N:`` labels per switch."""
    text = (Path(tfa.__file__).parent / "csrc" / source).read_text()
    out = []
    for m in re.finditer(r"switch \(D\) \{(.*?)\n  \}", text, re.S):
        out.append({int(n) for n in re.findall(r"case (\d+):", m.group(1))})
    return out


def test_every_head_dim_a_route_reaches_is_a_case_of_its_entrys_source():
    """Each entry's head dims are the cases of every ``switch (D)`` in its
    source, and a sweep of layouts (dtypes, D 1-256, T, groups, aligned and
    not) routes each D only to an entry whose source compiles it: a D that no
    kernel compiles cannot reach a launch, it raises before one."""
    for entry, source in SOURCES.items():
        cases = _switch_cases(source)
        assert cases and all(c == set(tfa.ENTRY_HEAD_DIMS[entry]) for c in cases), entry
    assert set(tfa.HEAD_DIMS) == set().union(*map(set, tfa.ENTRY_HEAD_DIMS.values()))
    reached = {entry: set() for entry in SOURCES}
    for dt in (torch.float32, torch.bfloat16):
        for d in range(1, 257):
            for hq, hkv, t, s in ((4, 4, 1, 70), (8, 1, 1, 40), (12, 2, 40, 40),
                                  (16, 16, 64, 64), (8, 2, 100, 130), (48, 8, 9, 9)):
                q = torch.empty(1, hq, t, d, dtype=dt)
                for k in (torch.empty(1, hkv, s, d, dtype=dt),
                          torch.empty(1 + hkv * s * d, dtype=dt)[1:].view(1, hkv, s, d)):
                    if d not in tfa.HEAD_DIMS:
                        with pytest.raises(ValueError, match="head dim"):
                            tfa._route(q, k, k)
                        continue
                    entry = tfa._route(q, k, k)
                    assert d in set.intersection(*_switch_cases(SOURCES[entry])), (entry, d)
                    reached[entry].add(d)
    assert 80 in reached["flash_attention_bf16_simt"] & reached["flash_attention_f32_simt"]
    assert 80 not in reached["flash_attention_f32"]
