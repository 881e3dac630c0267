"""The port's MoE (``models/moe.py``, the ``attn_moe`` block, mixtral-8x22b and
dbrx-132b) against the reference, on the CPU.

The same numpy-seeded inputs and the reference's own parameters (its
``init_moe`` or ``Model.init``, carried across by ``convert``) go through
both packages, in f32. Tolerances are the reference's:

- ``apply_moe`` against the reference's and against the dense oracle at
  2e-4 (tests/test_models.py:146); the keep mask, the slot positions and
  the capacity exactly;
- ``moe_split`` 2 and 4 against the unsplit oracle at 3e-4
  (tests/test_perf_knobs.py:67);
- a model's logits at 2e-4, attention's tolerance (tests/test_torch_lm.py);
- decode against teacher forcing at 2e-3 on the prefill logits and 5e-3 on
  the last step (tests/test_models.py:102-108), the ring past the window
  included (:111-129);
- one train step: the loss at 1e-5 relative, every gradient within
  2e-4 + 2e-4·|ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import SyntheticLM as RefSyntheticLM
from repro.launch.serve import serve as ref_serve
from repro.models import Model as RefModel
from repro.models import moe as rmoe
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.convert import model_state_from_reference
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import Model
from repro_torch.models import moe as tmoe

MOE_ARCHS = ["mixtral-8x22b", "dbrx-132b"]
MOE_TOL = 2e-4
SPLIT_TOL = 3e-4
LOGIT_TOL = 2e-4
PREFILL_TOL, DECODE_TOL = 2e-3, 5e-3
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4


def _cfgs(arch, **changes):
    """The reference's and the port's smoke config, f32, with ``changes``."""
    ref = dataclasses.replace(ref_smoke_config(arch), dtype="float32", **changes)
    port = dataclasses.replace(get_smoke_config(arch), dtype="float32", **changes)
    return ref, port


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _moe_params(rcfg, seed=0):
    """The reference's expert parameters and the port's copy of them."""
    p = rmoe.init_moe(jax.random.key(seed), rcfg)
    return p, {k: _t(v) for k, v in p.items()}


def _x(cfg, b, t, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(b, t, cfg.d_model)).astype(np.float32)


def _ref_dispatch(p, cfg, x):
    """The reference's combine weights, keep mask, slot positions and
    capacity, by its own lines (repro/models/moe.py:88-105)."""
    b, t, d = x.shape
    n = b * t
    g = min(cfg.moe_group_size, n)
    cap = max(1, int(round(cfg.top_k * g * cfg.capacity_factor / cfg.n_experts)))
    logits = jnp.asarray(x).reshape(n // g, g, d).astype(jnp.float32) @ p["router"]
    combine_w = rmoe._route(logits.reshape(n, cfg.n_experts), cfg.top_k).reshape(n // g, g, -1)
    if cfg.moe_split > 1:
        combine_w = jnp.repeat(combine_w, cfg.moe_split, axis=-1)
    sel = combine_w > 0
    pos = jnp.cumsum(sel.astype(jnp.int32), axis=1) - 1
    return np.asarray(combine_w), np.asarray(sel & (pos < cap)), np.asarray(pos), cap


def _check_dispatch(p, tp, rcfg, cfg, x):
    """Port against reference on x: the dispatch exactly, the output at
    MOE_TOL. -> (the reference's keep mask, selection)."""
    want_w, want_keep, want_pos, want_cap = _ref_dispatch(p, rcfg, x)
    combine_w, keep, pos = tmoe.route(tp, cfg, _t(x))
    assert tmoe.capacity(cfg, keep.shape[1]) == want_cap
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    _close(combine_w, want_w, MOE_TOL)
    got = tmoe.apply_moe(tp, cfg, _t(x))
    _close(got, rmoe.apply_moe(p, rcfg, jnp.asarray(x)), MOE_TOL)
    return want_keep, want_w > 0, got


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 2.0])
@pytest.mark.parametrize("group", [16, 64])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_reference_and_its_oracle(arch, group, capacity_factor):
    rcfg, cfg = _cfgs(arch, moe_group_size=group, capacity_factor=capacity_factor)
    p, tp = _moe_params(rcfg)
    x = _x(cfg, 2, 32)
    keep, sel, got = _check_dispatch(p, tp, rcfg, cfg, x)
    want_oracle = rmoe.moe_oracle(p, rcfg, jnp.asarray(x))
    _close(tmoe.moe_oracle(tp, cfg, _t(x)), want_oracle, MOE_TOL)
    dropped = not (keep == sel).all()
    # At 0.5 tokens drop; at E/k·... = 2.0 a buffer holds its whole group.
    assert dropped == (capacity_factor == 0.5) or capacity_factor == 1.25
    if not dropped:  # the dense oracle's output
        _close(got, want_oracle, MOE_TOL)


@pytest.mark.parametrize("capacity_factor,want_cap", [(0.3125, 2), (0.4375, 4)])
def test_capacity_rounds_halves_to_even_as_the_reference(capacity_factor, want_cap):
    # mixtral smoke: k·g·cf/E = 2·16·cf/4 = 2.5 and 3.5.
    rcfg, cfg = _cfgs("mixtral-8x22b", moe_group_size=16, capacity_factor=capacity_factor)
    assert tmoe.capacity(cfg, 16) == want_cap
    p, tp = _moe_params(rcfg, seed=2)
    keep, sel, _ = _check_dispatch(p, tp, rcfg, cfg, _x(cfg, 2, 16, seed=3))
    assert keep.sum(axis=1).max() == want_cap and not (keep == sel).all()


@pytest.mark.parametrize("split", [2, 4])
def test_moe_split_equals_unsplit(split):
    rcfg, cfg = _cfgs("mixtral-8x22b", capacity_factor=2.0, moe_group_size=16)
    p, tp = _moe_params(rcfg)
    x = _x(cfg, 2, 16)
    want = rmoe.moe_oracle(p, rcfg, jnp.asarray(x))
    tps = tmoe.split_moe_params(tp, split)
    for name, leaf in rmoe.split_moe_params(p, split).items():
        assert torch.equal(tps[name], _t(leaf)), name
    rcfg_s, cfg_s = (dataclasses.replace(c, moe_split=split) for c in (rcfg, cfg))
    got = tmoe.apply_moe(tps, cfg_s, _t(x))
    _close(got, want, SPLIT_TOL)
    _close(got, rmoe.apply_moe(rmoe.split_moe_params(p, split), rcfg_s, jnp.asarray(x)),
           MOE_TOL)
    want_keep = _ref_dispatch(rmoe.split_moe_params(p, split), rcfg_s, x)[1]
    np.testing.assert_array_equal(tmoe.route(tps, cfg_s, _t(x))[1].numpy(), want_keep)


@pytest.mark.parametrize("tied", [4, 3])
def test_ties_select_more_than_k_experts(tied):
    """Selection is weights >= the k-th largest: experts whose router
    columns are equal tie, and every one of them is selected."""
    rcfg, cfg = _cfgs("mixtral-8x22b", moe_group_size=16, capacity_factor=2.0)
    p, _ = _moe_params(rcfg)
    # Experts 0..tied-1 score exactly 0 for every token (zero columns), the
    # rest below them (x >= 0 against negative columns).
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[:, tied:] = -0.1
    p = dict(p, router=jnp.asarray(router))
    tp = {k: _t(v) for k, v in p.items()}
    x = np.abs(_x(cfg, 2, 16))
    keep, sel, _ = _check_dispatch(p, tp, rcfg, cfg, x)
    assert (sel.sum(-1) == tied).all() and tied > cfg.top_k and (keep == sel).all()
    assert (tmoe.route(tp, cfg, _t(x))[0].numpy()[..., :tied] > 0).all()


def test_tokens_that_do_not_split_into_groups_are_refused():
    _, cfg = _cfgs("dbrx-132b", moe_group_size=16)
    _, tp = _moe_params(_cfgs("dbrx-132b")[0])
    with pytest.raises(ValueError, match=r"B\*T = 24 .* g = 16"):
        tmoe.apply_moe(tp, cfg, torch.zeros(1, 24, cfg.d_model))
    model = Model(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="24"):
        model(torch.zeros(2, 12, dtype=torch.long))


def test_init_moe_shapes_dtypes_and_the_module_names():
    cfg = get_config("mixtral-8x22b")
    p = tmoe.init_moe(None, cfg)
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        "router": ((6144, 8), torch.float32),
        "w_gate": ((8, 6144, 16384), torch.bfloat16),
        "w_up": ((8, 6144, 16384), torch.bfloat16),
        "w_down": ((8, 16384, 6144), torch.bfloat16),
    }
    _, small = _cfgs("dbrx-132b")
    model = Model(small, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    names = dict(model.named_parameters())
    assert names["blocks.1.ffn.router"].dtype == torch.float32
    assert tuple(names["blocks.0.ffn.w_down"].shape) == (8, 96, 64)
    assert names["blocks.0.ffn.w_gate"].std().item() == pytest.approx(0.0176, rel=0.1)
    with pytest.raises(ValueError, match="moe_split"):
        tmoe.init_moe(None, dataclasses.replace(small, moe_split=5))


# ---------------------------------------------------------------------------
# The model: forward, decode, ring cache, one train step
# ---------------------------------------------------------------------------


def _models(arch, seed=0, **changes):
    rcfg, cfg = _cfgs(arch, **changes)
    ref = RefModel(rcfg, remat=False)
    params = ref.init(jax.random.key(seed))
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_state_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return ref, params, model


def _tokens(cfg, b, t, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, t)).astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_forward_matches_reference(arch):
    ref, params, model = _models(arch)
    assert {b.kind for b in model.blocks} == {"attn_moe"}
    tokens = _tokens(model.cfg, 2, 32)
    want = ref.forward(params, {"tokens": jnp.asarray(tokens)})
    got = model(_t(tokens).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    _close(got, want, LOGIT_TOL)


def _decode_against_teacher_forcing(arch, b, t, t0, max_len, **changes):
    """The reference's test (tests/test_models.py:92-129) on the port, and
    each step's logits against the reference's decode on the same weights."""
    ref, params, model = _models(arch, **changes)
    tokens = _tokens(model.cfg, b, t)
    full = model(_t(tokens).long())
    cache, got = model.prefill(_t(tokens[:, :t0]).long(), max_len)
    _close(got, full[:, :t0], PREFILL_TOL)
    ref_cache, want = ref.prefill(params, {"tokens": jnp.asarray(tokens[:, :t0])}, max_len)
    _close(got, want, LOGIT_TOL)
    for pos in range(t0, t):
        logits, cache = model.decode_step(cache, _t(tokens[:, pos]).long(), pos)
        want, ref_cache = ref.decode_step(params, ref_cache, jnp.asarray(tokens[:, pos]),
                                          jnp.int32(pos))
        _close(logits, want, LOGIT_TOL)
    _close(logits, full[:, t - 1], DECODE_TOL)
    return cache


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_teacher_forcing_and_the_reference(arch):
    _decode_against_teacher_forcing(arch, 2, 16, 8, 32)


def test_ring_cache_beyond_the_window_matches_teacher_forcing():
    cache = _decode_against_teacher_forcing("mixtral-8x22b", 1, 24, 4, 24, window=8)
    assert tuple(cache[0]["k"].shape[:2]) == (1, 8)


@pytest.mark.parametrize("route", ["kernel", "ref"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_one_train_step_loss_and_every_gradient_match_reference(arch, route):
    ref, params, model = _models(arch)
    model.remat = True
    batch = dict(RefSyntheticLM(vocab=model.cfg.vocab, batch=4, seq=16, seed=1).batch_at(0))
    (want, _), want_g = jax.value_and_grad(ref.loss_fn, has_aux=True)(params, batch)
    with ops.force_impl(route):
        loss, _ = model.loss_fn({k: _t(v) for k, v in batch.items()})
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    want_g = model_state_from_reference(model.cfg, jax.tree.map(np.asarray, want_g))
    assert sorted(names) == sorted(want_g)
    assert {"blocks.0.ffn.router", "blocks.1.ffn.w_down"} <= set(names)
    for name, g in zip(names, grads, strict=True):
        assert bool(g.abs().max() > 0) and bool(torch.isfinite(g).all()), name
        ref_g = want_g[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref_g, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_matches_reference_token_for_token(arch):
    kw = dict(n_requests=4, batch=2, prompt_len=16, gen_len=6, max_len=32, seed=0)
    want = ref_serve(arch=arch, smoke=True, **kw)
    _, _, model = _models(arch, seed=0)  # the weights the reference's serve draws
    got = tserve.serve(arch=arch, smoke=True, device="cpu", model=model, **kw)
    assert (got.requests, got.prefill_tokens, got.decoded_tokens) == (
        want.requests, want.prefill_tokens, want.decoded_tokens)
    assert got.outputs == want.outputs
    built = tserve.serve(arch=arch, device="cpu", **kw)  # from a seed, on the CPU
    assert [len(o) for o in built.outputs] == [6] * 4
    assert arch in ARCHS


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_runs_a_few_steps_and_the_loss_falls(arch):
    out = ttrain.train(arch=arch, smoke=True, steps=12, batch=4, seq=16, lr=3e-3,
                       log_every=0, seed=0, device="cpu")
    assert len(out["losses"]) == 12 and all(np.isfinite(out["grad_norms"]))
    assert out["final_loss"] < out["first_loss"]
    assert any(n.endswith("ffn.router") for n in out["params"])
