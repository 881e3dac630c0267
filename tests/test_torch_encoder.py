"""The audio encoder (hubert-xlarge) in the port against the reference, and
attention at its head dim of 80, on the CPU.

The encoder is bidirectional (``causal=False``), has no positional encoding
(``rope="none"``) and takes precomputed frame embeddings (its convolutional
frontend is a stub). The same numpy-seeded inputs and the reference's own
weights (its ``Model.init``, carried across by
``convert.model_state_from_reference``) go through both packages; attention
runs the kernel route, which is its plain version on CPU tensors.

Tolerances, each the existing tests' own: logits at 2e-4 (attention's, the
part computed in another order); the loss at 1e-5 relative and every
gradient at 1e-4 absolute (``tests/test_torch_train.py``); attention at
D = 80 against the reference's flash kernel in interpret mode at 2e-4 for
f32 and 2e-2 for bf16 (``tests/test_kernels_attention.py:39,48``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import SyntheticEmbeds as RefSyntheticEmbeds
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import Model as RefModel
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_reference, model_state_from_reference
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import Model

ARCH = "hubert-xlarge"
LOGIT_TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-4


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _models(seed=0):
    ref_cfg = dataclasses.replace(ref_smoke_config(ARCH), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    ref = RefModel(ref_cfg, remat=False)
    params = ref.init(jax.random.key(seed))
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_state_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return ref, params, model


def test_the_published_encoder_has_head_dim_80_which_routes_bf16_to_the_wgmma_kernel():
    cfg = get_config(ARCH)
    assert (cfg.head_dim, cfg.n_heads, cfg.n_kv_heads) == (80, 16, 16)
    assert cfg.encoder_only and not cfg.causal and cfg.rope == "none"
    q = torch.empty(8, 16, 4096, 80, dtype=torch.bfloat16)
    assert tfa._route(q, q, q) == "flash_attention_bf16_wgmma"
    assert tfa._route(q.float(), q.float(), q.float()) == "flash_attention_f32_simt"


def test_convert_carries_the_token_table_and_the_separate_unembedding():
    _, params, model = _models()
    state = model_state_from_reference(model.cfg, jax.tree.map(np.asarray, params))
    assert sorted(state) == sorted(model.state_dict())
    assert tuple(state["embed"].shape) == (model.cfg.vocab, model.cfg.d_model)
    assert tuple(state["unembed"].shape) == (model.cfg.d_model, model.cfg.vocab)
    for name, value in model.state_dict().items():
        assert torch.equal(value, state[name]), name
    assert torch.equal(model.unembed, _t(params["unembed"]))


def test_forward_on_frame_embeddings_matches_reference(rng):
    ref, params, model = _models()
    embeds = rng.normal(size=(2, 21, model.cfg.d_model)).astype(np.float32)
    want = ref.forward(params, {"embeds": jnp.asarray(embeds)})
    got = model({"embeds": _t(embeds)})
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_the_encoder_is_bidirectional():
    """The counterpart of tests/test_models.py::test_hubert_is_bidirectional:
    a perturbed last frame changes frame 0's output, and, on the reference's
    weights and inputs, by what the reference's does."""
    ref, params, model = _models()
    e = np.asarray(jax.random.normal(jax.random.key(1), (1, 12, model.cfg.d_model)))
    e2 = e.copy()
    e2[:, -1] += 1.0
    with torch.no_grad():
        out1, out2 = model({"embeds": _t(e)}), model({"embeds": _t(e2)})
    assert not np.allclose(out1[:, 0].numpy(), out2[:, 0].numpy())
    want = (np.asarray(ref.forward(params, {"embeds": jnp.asarray(e2)}))
            - np.asarray(ref.forward(params, {"embeds": jnp.asarray(e)})))[:, 0]
    np.testing.assert_allclose((out2 - out1)[:, 0].numpy(), want, rtol=0, atol=2 * LOGIT_TOL)


@pytest.mark.parametrize("route", ["kernel", "ref"])
def test_loss_and_gradients_match_reference(route):
    ref, params, model = _models()
    cfg = model.cfg
    batch = RefSyntheticEmbeds(d_model=cfg.d_model, vocab=cfg.vocab, batch=4, seq=16,
                               seed=1).batch_at(0)
    (want, _), want_g = jax.value_and_grad(ref.loss_fn, has_aux=True)(params, batch)
    before = tfa.backward_calls["attention_bwd_torch"]
    with ops.force_impl(route):
        loss, _ = model.loss_fn({k: _t(v) for k, v in batch.items()})
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()), materialize_grads=True)
    calls = tfa.backward_calls["attention_bwd_torch"] - before
    assert calls == (cfg.n_layers if route == "kernel" else 0)
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    want_g = model_state_from_reference(cfg, jax.tree.map(np.asarray, want_g))
    assert sorted(names) == sorted(want_g)
    for name, g in zip(names, grads, strict=True):
        if name == "embed":  # the token table takes no part in an embeddings forward
            assert not g.any() and not want_g[name].any()
            continue
        assert bool(g.abs().max() > 0), name
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), rtol=0, atol=GRAD_ATOL,
                                   err_msg=name)


def test_serve_refuses_the_encoder(capsys):
    with pytest.raises(ValueError, match="encoder-only"):
        tserve.serve(arch=ARCH, device="cpu")
    _, _, model = _models()
    with pytest.raises(ValueError, match="encoder-only"):
        tserve.serve(arch=ARCH, device="cpu", model=model)
    assert tserve.main(["--device", "cpu", "--arch", ARCH]) == 2
    assert "encoder-only" in capsys.readouterr().err


def test_train_runs_the_encoder_on_synthetic_frames():
    out = ttrain.train(arch=ARCH, smoke=True, steps=3, batch=2, seq=8, log_every=0,
                       device="cpu")
    assert out["steps"] == 3 and all(np.isfinite(out["losses"]))
    assert not ttrain._make_data(out["model"].cfg, 2, 8, 0).mrope


# ---------------------------------------------------------------------------
# Attention at D = 80
# ---------------------------------------------------------------------------


D80_CASES = [  # B, Hq, Hkv, T, S, causal, window: hubert's group 1, a group of 2, ragged T
    (1, 4, 4, 33, 33, False, None),
    (2, 4, 4, 17, 17, True, None),
    (1, 4, 2, 45, 45, True, None),
    (2, 4, 2, 7, 30, False, None),
    (1, 2, 1, 1, 50, True, 9),
]


@pytest.mark.parametrize("b,hq,hkv,t,s,causal,window", D80_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_at_head_dim_80_matches_reference_flash_kernel(rng, b, hq, hkv, t, s, causal,
                                                                 window, dtype):
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, hq, t, 80), (b, hkv, s, 80), (b, hkv, s, 80)))
    jdt = jnp.dtype(dtype)
    want = flash_attention_pallas(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                  causal=causal, window=window, block_q=16, block_k=16,
                                  interpret=True)
    qt, kt, vt = (x.to(getattr(torch, dtype)) for x in from_reference([q, k, v], "cpu"))
    plain = tfa.plain_calls
    got = ops.attention(qt, kt, vt, causal=causal, window=window, mode="kernel")
    assert tfa.plain_calls == plain + 1
    # On the card bf16 takes the wgmma entry from 64 packed rows (group 2 at
    # T 45), the SIMT one below; f32 at D 80 the SIMT one.
    wgmma = dtype == "bfloat16" and hq // hkv * t >= tfa.MIN_WGMMA_ROWS
    assert tfa._route(qt, kt, vt, window) == (
        "flash_attention_bf16_wgmma" if wgmma else
        f"flash_attention_{'f32' if dtype == 'float32' else 'bf16'}_simt")
    tol = 2e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
