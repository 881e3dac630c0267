"""M-RoPE and the VLM (qwen2-vl-2b) in the port against the reference, on
the CPU.

The same numpy-seeded inputs and the reference's own weights (its
``Model.init``, carried across by ``convert.model_state_from_reference``) go
through both packages. The VLM takes precomputed embeddings and (B, T, 3)
(t, h, w) position ids, laid out as Qwen2-VL lays out a prompt: text, then an
image of t x h x w patches (t fixed over the image, h and w over its grid,
all offset by the text before it), then text that continues from the largest
id + 1. Attention runs the kernel route, which is its plain version on CPU
tensors.

Tolerances, each the existing tests' own: the angles and the rotation at
1e-5 (``tests/test_torch_lm.py``'s ``test_rope_matches_reference``); a
model's logits and its decode steps at 2e-4 (attention's, the part computed
in another order); the loss at 1e-5 relative and every gradient at 1e-4
absolute (``tests/test_torch_train.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import SyntheticEmbeds as RefSyntheticEmbeds
from repro.models import Model as RefModel
from repro.models import layers as rl
from repro.optim import AdamW as RefAdamW
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import adamw_state_from_reference, model_state_from_reference
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import Model
from repro_torch.models import layers as tl

ARCH = "qwen2-vl-2b"
LAYER_TOL = 1e-5
LOGIT_TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-4


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def vlm_positions(batch: int, text: int, grid: tuple[int, int, int], tail: int) -> np.ndarray:
    """(B, T, 3) int32 ids of ``text`` tokens, an image of t x h x w patches,
    then ``tail`` tokens, as Qwen2-VL numbers them: text i gets (i, i, i);
    the image's patch (a, b, c) gets (text + a, text + b, text + c); the tail
    continues from the largest id so far + 1."""
    t, h, w = grid
    a, b, c = np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")
    image = text + np.stack([a.ravel(), b.ravel(), c.ravel()], axis=-1)
    start = image.max() + 1 if image.size else text
    ids = np.concatenate([np.repeat(np.arange(text)[:, None], 3, axis=1), image,
                          np.repeat(start + np.arange(tail)[:, None], 3, axis=1)])
    return np.broadcast_to(ids, (batch,) + ids.shape).astype(np.int32).copy()


def _cfgs(full=False, **changes):
    """The reference's and the port's config, f32, with ``changes``."""
    ref = ref_config(ARCH) if full else ref_smoke_config(ARCH)
    port = get_config(ARCH) if full else get_smoke_config(ARCH)
    return (dataclasses.replace(ref, dtype="float32", **changes),
            dataclasses.replace(port, dtype="float32", **changes))


def _models(seed=0):
    ref_cfg, cfg = _cfgs()
    ref = RefModel(ref_cfg, remat=False)
    params = ref.init(jax.random.key(seed))
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_state_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return ref, params, model


def _batch(rng, cfg, b, text, grid, tail) -> dict:
    positions = vlm_positions(b, text, grid, tail)
    t = positions.shape[1]
    return {"embeds": rng.normal(size=(b, t, cfg.d_model)).astype(np.float32),
            "positions": positions}


# ---------------------------------------------------------------------------
# The angles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("full,changes,want", [
    (False, {}, (2, 3, 3)),  # the smoke config's sections at half 8
    (True, {}, (16, 24, 24)),  # the published ones at half 64, theta 1e6
    (True, {"head_dim": 20}, (2, 3, 5)),  # rescaled to half 10: t and h rounded down
])
def test_mrope_angles_match_reference(rng, full, changes, want):
    ref_cfg, cfg = _cfgs(full, **changes)
    assert tl.mrope_sections(cfg) == want
    positions = vlm_positions(2, 5, (2, 3, 4), 4)
    positions[1] += 1000  # ids far from 0, where the rotations are many turns
    assert (positions[..., 0] != positions[..., 1]).any()
    cos_r, sin_r = rl.rope_angles(ref_cfg, jnp.asarray(positions))
    cos_t, sin_t = tl.rope_angles(cfg, _t(positions).long())
    assert tuple(cos_t.shape) == (2, positions.shape[1], cfg.head_dim // 2)
    assert cos_t.dtype == torch.float32
    _close(cos_t, cos_r, LAYER_TOL)
    _close(sin_t, sin_r, LAYER_TOL)
    x = rng.normal(size=(2, positions.shape[1], cfg.n_heads, cfg.head_dim)).astype(np.float32)
    _close(tl.apply_rope(_t(x), cos_t, sin_t), rl.apply_rope(jnp.asarray(x), cos_r, sin_r),
           LAYER_TOL)


@pytest.mark.parametrize("full", [False, True])
def test_mrope_with_three_equal_ids_is_plain_rope_bit_for_bit(rng, full):
    _, cfg = _cfgs(full)
    ids = rng.integers(0, 40000, size=(3, 11))
    cos3, sin3 = tl.rope_angles(cfg, _t(np.repeat(ids[..., None], 3, axis=-1)))
    cos, sin = tl.rope_angles(cfg, _t(ids))
    assert torch.equal(cos3, cos) and torch.equal(sin3, sin)


def test_rope_angles_refuse_other_position_shapes():
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match=r"\(B, T\) or \(B, T, 3\)"):
        tl.rope_angles(cfg, torch.zeros(1, 4, 2, dtype=torch.long))


# ---------------------------------------------------------------------------
# The model, on the reference's weights
# ---------------------------------------------------------------------------


def test_convert_carries_every_parameter_of_the_vlm():
    """QKV biases, the tied token table; the state dict's names equal the
    port model's, every value the reference's."""
    ref, params, model = _models()
    state = model_state_from_reference(model.cfg, jax.tree.map(np.asarray, params))
    assert sorted(state) == sorted(model.state_dict())
    assert "unembed" not in state and "blocks.1.mixer.bq" in state
    for name, value in model.state_dict().items():
        assert torch.equal(value, state[name]), name
    assert torch.equal(model.embed, _t(params["embed"]))
    assert torch.equal(model.blocks[1].mixer["bk"], _t(params["blocks"][0]["mixer"]["bk"][1]))
    opt = adamw_state_from_reference(model.cfg, jax.tree.map(np.asarray,
                                                             RefAdamW().init(params)))
    assert sorted(opt.m) == sorted(opt.v) == sorted(state)


def test_forward_on_embeds_and_image_positions_matches_reference(rng):
    ref, params, model = _models()
    batch = _batch(rng, model.cfg, 2, 4, (1, 3, 4), 5)
    want = ref.forward(params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = model({k: _t(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    _close(got, want, LOGIT_TOL)


def test_default_positions_are_arange_in_each_component(rng):
    ref, params, model = _models()
    embeds = rng.normal(size=(2, 9, model.cfg.d_model)).astype(np.float32)
    want = ref.forward(params, {"embeds": jnp.asarray(embeds)})
    got = model({"embeds": _t(embeds)})
    _close(got, want, LOGIT_TOL)
    explicit = model({"embeds": _t(embeds), "positions": _t(vlm_positions(2, 9, (0, 0, 0), 0))})
    assert torch.equal(got, explicit)


def test_prefill_and_eight_decode_steps_match_reference(rng):
    ref, params, model = _models()
    batch = _batch(rng, model.cfg, 3, 3, (2, 2, 3), 4)
    max_len = 40
    ref_cache, want = ref.prefill(params, {k: jnp.asarray(v) for k, v in batch.items()}, max_len)
    cache, got = model.prefill({k: _t(v) for k, v in batch.items()}, max_len)
    _close(got, want, LOGIT_TOL)
    for i, entry in enumerate(cache):  # the reference stacks layers on axis 0
        for name in ("k", "v"):
            _close(entry[name], ref_cache[0][name][i], LAYER_TOL)
    last = np.asarray(want[:, -1]).argmax(-1).astype(np.int32)
    start = batch["positions"].shape[1]
    for i in range(8):
        pos = start + i
        want, ref_cache = ref.decode_step(params, ref_cache, jnp.asarray(last), jnp.int32(pos))
        got, cache = model.decode_step(cache, _t(last).long(), pos)
        _close(got, want, LOGIT_TOL)
        last = np.asarray(want).argmax(-1).astype(np.int32)


def test_decode_positions_are_the_slot_not_the_grids_next_id(rng):
    """The reference's decode step puts the token at (pos, pos, pos), pos its
    cache slot, not at published Qwen2-VL's largest id + 1 after a
    compressed image grid (ROADMAP.md queue 3). The port mirrors it: decode
    equals the full forward fed the decoded tokens' embeddings at (pos,
    pos, pos), and differs from one fed the grid's next ids."""
    _, _, model = _models()
    batch = _batch(rng, model.cfg, 2, 2, (1, 6, 6), 2)
    t0 = batch["positions"].shape[1]
    assert batch["positions"].max() + 1 < t0  # the grid compressed the ids
    tokens = rng.integers(0, model.cfg.vocab, size=(2, 3))
    cache, _ = model.prefill({k: _t(v) for k, v in batch.items()}, 48)
    for i in range(3):
        logits, cache = model.decode_step(cache, _t(tokens[:, i]).long(), t0 + i)
    with torch.no_grad():
        embeds = torch.cat([_t(batch["embeds"]), model.embed[_t(tokens).long()]], dim=1)
        slot = np.repeat((t0 + np.arange(3))[None, :, None], 3, axis=-1)
        nxt = np.repeat((batch["positions"].max() + 1 + np.arange(3))[None, :, None], 3, -1)
        full = model({"embeds": embeds, "positions": _t(np.concatenate(
            [batch["positions"], np.broadcast_to(slot, (2, 3, 3))], axis=1))})
        deltas = model({"embeds": embeds, "positions": _t(np.concatenate(
            [batch["positions"], np.broadcast_to(nxt, (2, 3, 3))], axis=1))})
    _close(logits, full[:, -1], LOGIT_TOL)
    assert not np.allclose(logits.numpy(), deltas[:, -1].numpy(), rtol=LOGIT_TOL,
                           atol=LOGIT_TOL)


@pytest.mark.parametrize("route", ["kernel", "ref"])
def test_loss_and_gradients_match_reference(route):
    ref, params, model = _models()
    cfg = model.cfg
    batch = dict(RefSyntheticEmbeds(d_model=cfg.d_model, vocab=cfg.vocab, batch=4, seq=16,
                                    mrope=True, seed=1).batch_at(0))
    batch["positions"] = jnp.asarray(vlm_positions(4, 3, (1, 2, 4), 5))
    (want, _), want_g = jax.value_and_grad(ref.loss_fn, has_aux=True)(params, batch)
    before = tfa.backward_calls["attention_bwd_torch"]
    with ops.force_impl(route):
        loss, _ = model.loss_fn({k: _t(v) for k, v in batch.items()})
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
    calls = tfa.backward_calls["attention_bwd_torch"] - before
    assert calls == (cfg.n_layers if route == "kernel" else 0)
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    want_g = model_state_from_reference(cfg, jax.tree.map(np.asarray, want_g))
    assert sorted(names) == sorted(want_g)
    for name, g in zip(names, grads, strict=True):
        assert bool(g.abs().max() > 0), name
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), rtol=0, atol=GRAD_ATOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------


def test_serve_refuses_the_vlm_naming_its_token_prompts(capsys):
    with pytest.raises(ValueError, match="feeds token prompts"):
        tserve.serve(arch=ARCH, device="cpu")
    _, _, model = _models()
    with pytest.raises(ValueError, match="feeds token prompts"):
        tserve.serve(arch=ARCH, device="cpu", model=model)
    assert tserve.main(["--device", "cpu", "--arch", ARCH]) == 2
    assert "feeds token prompts" in capsys.readouterr().err


def test_serve_schedule_on_embeddings_gives_the_references_greedy_tokens(rng):
    """``serve``'s rounds (``_serve_rounds``: 3 requests in rounds of 2, the
    second padded) fed embeddings give each request the greedy tokens of the
    reference's own ``prefill`` and ``decode_step`` on that request alone."""
    ref, params, model = _models()
    batch = _batch(rng, model.cfg, 3, 3, (2, 2, 3), 4)
    prompt_len, gen_len, max_len = batch["positions"].shape[1], 5, 40
    stats = tserve._serve_rounds(
        model, lambda idx: {k: _t(v[idx]) for k, v in batch.items()}, n_requests=3, batch=2,
        prompt_len=prompt_len, gen_len=gen_len, max_len=max_len)
    assert (stats.prefill_tokens, stats.decoded_tokens) == (3 * prompt_len, 3 * (gen_len - 1))
    for req, got in enumerate(stats.outputs):
        one = {k: jnp.asarray(v[req:req + 1]) for k, v in batch.items()}
        cache, logits = ref.prefill(params, one, max_len)
        want = [int(np.asarray(logits[0, -1]).argmax())]
        for pos in range(prompt_len, prompt_len + gen_len - 1):
            logits, cache = ref.decode_step(params, cache, jnp.asarray(want[-1:], jnp.int32),
                                            jnp.int32(pos))
            want.append(int(np.asarray(logits[0]).argmax()))
        assert got == want, req


def test_train_runs_the_vlm_on_synthetic_embeddings():
    out = ttrain.train(arch=ARCH, smoke=True, steps=3, batch=2, seq=8, log_every=0,
                       device="cpu")
    assert out["steps"] == 3 and all(np.isfinite(out["losses"]))
    data = ttrain._make_data(out["model"].cfg, 2, 8, 0)
    assert data.mrope and set(data.batch_at(0)) == {"embeds", "labels", "positions"}

