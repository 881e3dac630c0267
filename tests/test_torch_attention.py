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
        tfa.flash_attention_cuda(q, q, q, block_q=128)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention_cuda(q, q, q, window=-1)
    # A layout it takes, on the CPU: refused for the device, not run.
    launches = dict(tfa.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, torch.ones(1, 2, 5, 16), torch.ones(1, 2, 5, 16))
    assert tfa.launches == launches


def test_attention_is_a_kernel_op_with_one_compiled_tile():
    assert ops.KERNEL_OPS["attention"] is tfa
    assert ops.tune_space("attention") == ({"block_q": 32, "block_k": 64},)
    with pytest.raises(KeyError, match="unknown kernel op"):
        ops.tune_space("flash")
