"""Decode over a cache split on its keys, in one process: each row's
log-sum-exp from the attention entries' plain versions, the split rule's
merge (``ops.merge_key_splits``) and attention's ``kv_len``.

- The lse of ``flash_attention_plain`` (the ``ref.py`` oracle) and of
  ``flash_decode_plain`` (the decode kernel's split-and-merge) against a
  float64 log-sum-exp of the scaled scores within 1e-5, for groups 1, 4, 6
  and 8, D 64 and 128, f32 and bf16, a cache of 100 slots (its last 64-key
  tile partial) and several ``kv_len``; each output bit-equal to the same
  call without ``return_lse``.
- The merge of 1, 2, 4 and 16 slices of a cache (16 is the production model
  axis; with a short ``kv_len`` the last slices hold no valid slot), each
  slice through the kernel route with ``return_lse``, against the
  reference's ``repro.models.layers.sdpa(..., kv_len=...)`` on the same
  numpy-seeded inputs, at the reference's tolerances (2e-4 f32, 2e-2 bf16;
  ``tests/test_kernels_attention.py:39,48``); one slice bit-equal to the
  unsplit call.
- ``ops.attention(kv_len=...)`` on plain tensors bit-equal to the call on
  the sliced cache, as the decode step made it before; ``return_lse`` on an
  entry that writes none raises before any launch; the meta route's lse.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import sdpa as ref_sdpa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

S = 100  # cache slots: one whole 64-key tile and a partial one
KV_LENS = (1, 37, 64, 100)
LSE_TOL = 1e-5
REF_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
DTYPES = (torch.float32, torch.bfloat16)


def _qkv(seed, b, hq, hkv, t, s, d, dtype):
    """q (B, Hq, T, D), k and v (B, Hkv, S, D) from a numpy generator, as
    numpy arrays (f32, rounded to ``dtype``) and tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32)
              for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d))]
    tensors = [torch.from_numpy(a).to(dtype) for a in arrays]
    return [x.float().numpy() for x in tensors], tensors


def _lse64(q, k, *, causal, scale=None):
    """float64 log-sum-exp of each row's scaled, masked scores (queries at
    the last T of the S keys)."""
    qd, kd = q.double(), k.double()
    b, hq, t, d = q.shape
    kx = kd.repeat_interleave(hq // k.shape[1], dim=1)
    sc = torch.einsum("bhtd,bhsd->bhts", qd, kx) * (d**-0.5 if scale is None else scale)
    if causal:
        s = k.shape[2]
        mask = torch.arange(s)[None, :] <= torch.arange(t)[:, None] + (s - t)
        sc = sc.masked_fill(~mask, float("-inf"))
    return torch.logsumexp(sc, dim=-1)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("d", (64, 128))
@pytest.mark.parametrize("group", (1, 4, 6, 8))
def test_each_plain_versions_lse_is_the_float64_logsumexp(group, d, dtype):
    _, (q, k, v) = _qkv(group * d, 2, 2 * group, 2, 1, S, d, dtype)
    for kv_len in KV_LENS:
        ks, vs = k[:, :, :kv_len], v[:, :, :kv_len]
        want = _lse64(q, ks, causal=False)
        out, lse = fa.flash_attention_plain(q, ks, vs, return_lse=True)
        assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
        torch.testing.assert_close(lse.double(), want, rtol=0, atol=LSE_TOL)
        assert torch.equal(out, fa.flash_attention_plain(q, ks, vs))
        for splits in (1, 2, 3):
            out, lse = fa.flash_decode_plain(q, ks, vs, splits=splits, return_lse=True)
            torch.testing.assert_close(lse.double(), want, rtol=0, atol=LSE_TOL)
            assert torch.equal(out, fa.flash_decode_plain(q, ks, vs, splits=splits))


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
def test_lse_with_masks_and_rows_that_see_no_key(dtype):
    """Causal rows over T > 1 against the float64 log-sum-exp; a window that
    hides every key of a row gives -inf there, on both plain versions."""
    _, (q, k, v) = _qkv(7, 2, 8, 2, 3, S, 64, dtype)
    out, lse = fa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    torch.testing.assert_close(lse.double(), _lse64(q, k, causal=True), rtol=0, atol=LSE_TOL)
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, causal=True))
    _, lse_d = fa.flash_decode_plain(q, k, v, causal=True, splits=2, return_lse=True)
    torch.testing.assert_close(lse_d, lse, rtol=0, atol=LSE_TOL)
    # T 3 against 2 keys, causal: query 0 sits at position -1 and sees none.
    for plain in (fa.flash_attention_plain, fa.flash_decode_plain):
        _, lse = plain(q, k[:, :, :2], v[:, :, :2], causal=True, return_lse=True)
        assert torch.isneginf(lse[:, :, 0]).all() and torch.isfinite(lse[:, :, 1:]).all()


def _stacked(x, op):
    """The merge's reduction over slices stacked on a leading axis."""
    return x.amax(0, keepdim=True) if op == "max" else x.sum(0, keepdim=True)


def _split_and_merge(q, k, v, m, kv_len):
    """Each of ``m`` slices of the keys through the kernel route with its
    lse (the split rule's per-rank work; an empty slice contributes 0 and
    -inf), merged by ``ops.merge_key_splits``."""
    s = k.shape[2]
    outs, lses = [], []
    for i in range(m):
        lo = i * s // m
        valid = max(0, min(kv_len - lo, s // m))
        if valid:
            out, lse = ops.attention(q, k[:, :, lo:lo + valid], v[:, :, lo:lo + valid],
                                     mode="kernel", return_lse=True)
        else:
            out, lse = torch.zeros_like(q), torch.full(q.shape[:3], float("-inf"))
        outs.append(out)
        lses.append(lse)
    return ops.merge_key_splits(torch.stack(outs), torch.stack(lses), _stacked)[0]


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("m", (1, 2, 4, 16))
def test_the_merge_of_key_slices_matches_the_references_sdpa(m, dtype):
    b, group, hkv, s, d = 2, 4, 2, 64, 64
    arrays, (q, k, v) = _qkv(m, b, group * hkv, hkv, 1, s, d, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(np.swapaxes(a, 1, 2), dtype=jdt) for a in arrays)
    tol = REF_TOL[dtype]
    for kv_len in (1, 23, 40, s):  # 1 and 23: the last slices of 4 and 16 hold no valid slot
        got = _split_and_merge(q, k, v, m, kv_len)
        assert got.dtype == dtype and got.shape == q.shape
        want = ref_sdpa(jq, jk, jv, causal=False, window=None, kv_len=jnp.int32(kv_len))
        np.testing.assert_allclose(got.float().transpose(1, 2).numpy(),
                                   np.asarray(want, dtype=np.float32), rtol=tol, atol=tol,
                                   err_msg=f"{m} slices, kv_len {kv_len}")
        if m == 1:  # one slice: w = 1, a division by 1
            assert torch.equal(got, ops.attention(q, k, v, mode="kernel", kv_len=kv_len))


@pytest.mark.parametrize("mode", ("ref", "kernel"))
@pytest.mark.parametrize("causal", (False, True))
def test_kv_len_is_the_sliced_cache_bit_for_bit(mode, causal):
    """The decode step's call before ``kv_len``: the cache (B, S, Hkv, D)
    sliced to its first ``kv_len`` slots, transposed."""
    _, (q, k, v) = _qkv(3, 2, 8, 2, 1, S, 64, torch.float32)
    cache_k, cache_v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    for kv_len in KV_LENS:
        want = ops.attention(q, cache_k[:, :kv_len].transpose(1, 2),
                             cache_v[:, :kv_len].transpose(1, 2), causal=causal, mode=mode)
        got = ops.attention(q, cache_k.transpose(1, 2), cache_v.transpose(1, 2),
                            causal=causal, mode=mode, kv_len=kv_len)
        assert torch.equal(got, want)


def test_lse_only_where_an_entry_writes_it():
    """The routes that write no lse (the wgmma prefill, the SIMT entries)
    raise ``ValueError`` before any launch; the decode and the f32 TMA
    entries route with it; the meta route returns its shape; autograd and
    vmap take no lse."""
    bf16 = torch.bfloat16
    prefill = [torch.zeros(1, 2, 64, 64, dtype=bf16)] + [torch.zeros(1, 2, 64, 64, dtype=bf16)] * 2
    assert fa._route(*prefill) == "flash_attention_bf16_wgmma"
    with pytest.raises(ValueError, match="writes no log-sum-exp"):
        fa.flash_attention_cuda(*prefill, return_lse=True)
    odd = [torch.zeros(1, 2, 20, 80)] + [torch.zeros(1, 2, 20, 80)] * 2  # f32 at D 80: SIMT
    assert fa._route(*odd) == "flash_attention_f32_simt"
    with pytest.raises(ValueError, match="writes no log-sum-exp"):
        fa._launch("flash_attention_f32_simt", *odd, return_lse=True)
    meta = [torch.empty(2, 8, 1, 128, dtype=bf16, device="meta")] + \
        [torch.empty(2, 2, 100, 128, dtype=bf16, device="meta")] * 2
    with ops.force_impl("kernel"):
        out, lse = ops.attention(*meta, return_lse=True)
    assert out.shape == (2, 8, 1, 128) and lse.shape == (2, 8, 1) and lse.dtype == torch.float32
    q = torch.zeros(1, 2, 1, 16, requires_grad=True)
    with pytest.raises(ValueError, match="return_lse"):
        ops.attention(q, torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 4, 16), mode="kernel",
                      return_lse=True)
