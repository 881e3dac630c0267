"""The port's LM serving path against the reference, on the CPU.

The same numpy-seeded inputs and the reference's own weights (its
``Model.init``, carried across by ``convert.model_state_from_reference``) go
through both packages: each ported layer against its reference function, the
``Model`` (forward, prefill, cached decode) for the dense smoke configs, and
``launch.serve.serve`` token for token. Attention runs the kernel route,
which is its plain version on CPU tensors.

Tolerances: the layers in f32 at 1e-5 (the reference's f32 kernel
tolerance), attention at 2e-4 (tests/test_kernels_attention.py:56, kernel
against the model's sdpa); a model's logits at 2e-4, attention's tolerance,
since attention is the part of the stack computed in another order.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as ref_archs
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch.serve import serve as ref_serve
from repro.models import Model as RefModel
from repro.models import layers as rl
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.convert import model_state_from_reference
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.models import Model
from repro_torch.models import layers as tl
from repro_torch.models.config import ArchConfig

ROOT = Path(__file__).resolve().parents[1]
LAYER_TOL = 1e-5
ATTN_TOL = 2e-4
LOGIT_TOL = 2e-4
SMOKE_ARCHS = ["granite-3-8b", "qwen1.5-0.5b"]


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


def _attn_params(rng, cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    if cfg.qkv_bias:  # random, not the init's zeros, so the bias is exercised
        shapes.update(bq=(cfg.n_heads * hd,), bk=(cfg.n_kv_heads * hd,),
                      bv=(cfg.n_kv_heads * hd,))
    return {k: (0.1 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# (b) the layers, one by one
# ---------------------------------------------------------------------------


def test_rms_norm_matches_reference(rng):
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=(64,))).astype(np.float32)
    _close(tl.rms_norm(_t(x), _t(gamma), 1e-5), rl.rms_norm(jnp.asarray(x), gamma, 1e-5),
           LAYER_TOL)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_rope_matches_reference(rng, arch):
    ref_cfg, cfg = _cfgs(arch)
    positions = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    cos_r, sin_r = rl.rope_angles(ref_cfg, jnp.asarray(positions))
    cos_t, sin_t = tl.rope_angles(cfg, _t(positions).long())
    _close(cos_t, cos_r, LAYER_TOL)
    _close(sin_t, sin_r, LAYER_TOL)
    x = rng.normal(size=(2, 7, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    _close(tl.apply_rope(_t(x), cos_t, sin_t), rl.apply_rope(jnp.asarray(x), cos_r, sin_r),
           LAYER_TOL)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_rope_at_the_published_head_dim_and_long_positions_matches_reference(rng, arch):
    """head_dim 128 and 64, theta 1e4 and 1e6, positions to 32768: the
    frequency table must round as the reference's (XLA's f32 power is
    correctly rounded), or an ulp's difference grows with the position."""
    ref_cfg = dataclasses.replace(ref_config(arch), dtype="float32")
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    positions = rng.integers(0, 32768, size=(2, 9)).astype(np.int32)
    cos_r, sin_r = rl.rope_angles(ref_cfg, jnp.asarray(positions))
    cos_t, sin_t = tl.rope_angles(cfg, _t(positions).long())
    _close(cos_t, cos_r, LAYER_TOL)
    _close(sin_t, sin_r, LAYER_TOL)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_project_qkv_matches_reference(rng, arch):
    ref_cfg, cfg = _cfgs(arch)
    p = _attn_params(rng, cfg)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(9), (2, 9))
    want = rl.project_qkv(p, ref_cfg, jnp.asarray(x), jnp.asarray(positions))
    got = tl.project_qkv({k: _t(v) for k, v in p.items()}, cfg, _t(x), _t(positions).long())
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, LAYER_TOL)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
@pytest.mark.parametrize("window", [None, 5])
def test_apply_attention_matches_reference_sdpa(rng, arch, window):
    ref_cfg, cfg = _cfgs(arch, window=window)
    p = _attn_params(rng, cfg)
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(11), (2, 11))
    want, (wk, wv) = rl.apply_attention(p, ref_cfg, jnp.asarray(x), jnp.asarray(positions))
    plain = tfa.plain_calls
    got, (gk, gv) = tl.apply_attention({k: _t(v) for k, v in p.items()}, cfg, _t(x),
                                       _t(positions).long())
    assert tfa.plain_calls == plain  # a CPU tensor under mode "auto": the oracle
    _close(got, want, ATTN_TOL)
    _close(gk, wk, LAYER_TOL)
    _close(gv, wv, LAYER_TOL)


def test_apply_mlp_matches_reference(rng):
    d, ff = 64, 128
    p = {k: (0.1 * rng.normal(size=s)).astype(np.float32)
         for k, s in (("w_gate", (d, ff)), ("w_up", (d, ff)), ("w_down", (ff, d)))}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    _close(tl.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x)),
           rl.apply_mlp(p, jnp.asarray(x)), LAYER_TOL)


# ---------------------------------------------------------------------------
# (c) the Model end to end, on the reference's weights
# ---------------------------------------------------------------------------


def _models(arch, seed=0, **changes):
    ref_cfg, cfg = _cfgs(arch, **changes)
    ref = RefModel(ref_cfg, remat=False)
    params = ref.init(jax.random.key(seed))
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_state_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return ref, params, model


def _tokens(rng, cfg, b, t) -> np.ndarray:
    return rng.integers(0, cfg.vocab, size=(b, t)).astype(np.int32)


def _decode_both(ref, params, model, ref_cache, cache, first, start, steps):
    """Teacher-forced decode: both models take the reference's greedy token
    at every step; their logits are compared at each."""
    last = first
    for i in range(steps):
        pos = start + i
        want, ref_cache = ref.decode_step(params, ref_cache, jnp.asarray(last), jnp.int32(pos))
        got, cache = model.decode_step(cache, _t(last).long(), pos)
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, LOGIT_TOL)
        last = np.asarray(want).argmax(-1).astype(np.int32)
    return ref_cache, cache


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_model_forward_matches_reference(rng, arch):
    ref, params, model = _models(arch)
    tokens = _tokens(rng, model.cfg, 2, 12)
    want = ref.forward(params, {"tokens": jnp.asarray(tokens)})
    got = model(_t(tokens).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_model_prefill_and_cached_decode_match_reference(rng, arch):
    ref, params, model = _models(arch)
    tokens = _tokens(rng, model.cfg, 3, 10)
    max_len = 24
    ref_cache, want = ref.prefill(params, {"tokens": jnp.asarray(tokens)}, max_len)
    cache, got = model.prefill(_t(tokens).long(), max_len)
    _close(got, want, LOGIT_TOL)
    assert len(cache) == model.cfg.n_layers
    for i, entry in enumerate(cache):  # the reference stacks layers on axis 0
        for name in ("k", "v"):
            assert tuple(entry[name].shape) == (3, max_len, model.cfg.n_kv_heads,
                                                model.cfg.head_dim)
            _close(entry[name], ref_cache[0][name][i], LAYER_TOL)
    first = np.asarray(want[:, -1]).argmax(-1).astype(np.int32)
    _decode_both(ref, params, model, ref_cache, cache, first, 10, 8)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_sliding_window_ring_cache_matches_reference(rng, arch):
    """window=8 with a 13-token prompt: prefill packs the last 8 tokens into
    the ring (slot p % 8), and decode keeps writing it round."""
    ref, params, model = _models(arch, window=8)
    tokens = _tokens(rng, model.cfg, 2, 13)
    ref_cache, want = ref.prefill(params, {"tokens": jnp.asarray(tokens)}, 32)
    cache, got = model.prefill(_t(tokens).long(), 32)
    _close(got, want, LOGIT_TOL)
    assert tuple(cache[0]["k"].shape[:2]) == (2, 8)
    _close(cache[1]["k"], ref_cache[0]["k"][1], LAYER_TOL)
    first = np.asarray(want[:, -1]).argmax(-1).astype(np.int32)
    _decode_both(ref, params, model, ref_cache, cache, first, 13, 8)


def test_init_cache_shape_and_init_weights():
    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"), dtype="float32")
    model = Model(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    cache = model.init_cache(5, 40)
    assert len(cache) == cfg.n_layers
    assert tuple(cache[0]["v"].shape) == (5, 40, cfg.n_kv_heads, cfg.head_dim)
    assert not cache[0]["k"].any()
    wq = model.blocks[0].mixer["wq"]
    assert wq.abs().max().item() <= 0.04 + 1e-7  # 0.02 times a normal cut at 2
    assert 0.012 < wq.std().item() < 0.022
    assert torch.equal(model.ln_f, torch.ones(cfg.d_model))
    again = Model(cfg, device="cpu")
    again.init_weights(torch.Generator().manual_seed(3))
    assert torch.equal(again.embed, model.embed)
    window = Model(dataclasses.replace(cfg, window=8), device="cpu")
    assert tuple(window.init_cache(2, 40)[0]["k"].shape) == (2, 8, cfg.n_kv_heads,
                                                            cfg.head_dim)


# ---------------------------------------------------------------------------
# (d) serve, token for token
# ---------------------------------------------------------------------------


def _reference_gap(arch, seed, batch, prompt_len, max_len, outputs, req):
    """The reference's top-2 logit gap at every step of request ``req``, on
    its own greedy path (for the message when a token differs)."""
    ref, params, _ = _models(arch, seed)
    cfg = ref.cfg
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
               for _ in range(len(outputs))]
    start = (req // batch) * batch
    idx = list(range(start, min(start + batch, len(outputs))))
    idx += [idx[-1]] * (batch - len(idx))
    slot = req - start
    cache, logits = ref.prefill(params, {"tokens": jnp.asarray(np.stack([prompts[i] for i in idx]))},
                                max_len)
    rows = [np.asarray(logits[:, -1])]
    last = np.asarray(logits[:, -1]).argmax(-1).astype(np.int32)
    for step in range(len(outputs[req]) - 1):
        logits, cache = ref.decode_step(params, cache, jnp.asarray(last),
                                        jnp.int32(prompt_len + step))
        rows.append(np.asarray(logits))
        last = np.asarray(logits).argmax(-1).astype(np.int32)
    gaps = []
    for row in rows:
        top2 = np.sort(row[slot])[-2:]
        gaps.append(float(top2[1] - top2[0]))
    return gaps


@pytest.mark.parametrize("arch,n_requests,batch", [
    ("granite-3-8b", 8, 4),
    ("granite-3-8b", 5, 4),  # the second round pads 3 idle slots
    ("qwen1.5-0.5b", 6, 3),
])
def test_serve_matches_reference_token_for_token(arch, n_requests, batch):
    kw = dict(n_requests=n_requests, batch=batch, prompt_len=16, gen_len=16, max_len=64,
              seed=0)
    want = ref_serve(arch=arch, smoke=True, **kw)
    _, _, model = _models(arch, seed=0)  # the weights the reference's serve draws
    got = tserve.serve(arch=arch, smoke=True, device="cpu", model=model, **kw)
    assert (got.requests, got.prefill_tokens, got.decoded_tokens) == (
        want.requests, want.prefill_tokens, want.decoded_tokens)
    for req, (g, w) in enumerate(zip(got.outputs, want.outputs, strict=True)):
        assert len(g) == len(w)
        if g == w:
            continue
        step = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        gap = _reference_gap(arch, 0, batch, 16, 64, want.outputs, req)[step]
        # Excused only where the reference's own top-2 gap lies within the
        # logit tolerance: a tie that attention's order of sums may break.
        assert gap < LOGIT_TOL, (
            f"request {req} differs at step {step}: port {g[step]}, reference {w[step]}; "
            f"the reference's top-2 logit gap there is {gap:.3e}")


def test_serve_builds_its_model_from_a_seed_and_the_cli_runs(capsys):
    stats = tserve.serve(arch="granite-3-8b", device="cpu", n_requests=3, batch=2,
                         prompt_len=5, gen_len=4, max_len=12, seed=1)
    assert (stats.requests, stats.prefill_tokens, stats.decoded_tokens) == (3, 15, 9)
    assert [len(o) for o in stats.outputs] == [4, 4, 4]
    again = tserve.serve(arch="granite-3-8b", device="cpu", n_requests=3, batch=2,
                         prompt_len=5, gen_len=4, max_len=12, seed=1)
    assert again.outputs == stats.outputs
    assert tserve.main(["--device", "cpu", "--arch", "deepseek-7b", "--requests", "2",
                        "--batch", "2", "--prompt-len", "4", "--gen-len", "3"]) == 0
    assert "[serve] 2 requests, 8 prefill + 4 decoded tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# (e) the configs and input modes, and what the port refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["hubert-xlarge", "qwen2-vl-2b"])
def test_encoder_and_vlm_configs_equal_the_references_field_for_field(arch):
    assert arch in ARCHS and ARCHS == ref_archs
    for port, ref in ((get_config, ref_config), (get_smoke_config, ref_smoke_config)):
        assert dataclasses.asdict(port(arch)) == dataclasses.asdict(ref(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        get_smoke_config("llama-9000")


def _base_config() -> ArchConfig:
    return ArchConfig(name="enc-smoke", family="audio", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, head_dim=16, d_ff=128, vocab=128, dtype="float32")


def test_an_embeds_model_builds_and_runs_on_embeddings_only(rng):
    """``input_mode="embeds"``: forward, prefill and the loss on a batch of
    embeddings (cast to the model's dtype); a token batch is refused."""
    cfg = dataclasses.replace(_base_config(), input_mode="embeds")
    model = Model(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    embeds = _t(rng.normal(size=(2, 6, cfg.d_model)).astype(np.float64))
    logits = model({"embeds": embeds})
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 6, cfg.vocab)
    assert torch.equal(logits, model({"embeds": embeds.float()}))
    cache, prefill = model.prefill({"embeds": embeds}, 8)
    torch.testing.assert_close(prefill, logits, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    loss, _ = model.loss_fn({"embeds": embeds, "labels": _t(_tokens(rng, cfg, 2, 6))})
    assert bool(torch.isfinite(loss))
    with pytest.raises(ValueError, match="embeds"):
        model(_t(_tokens(rng, cfg, 2, 6)).long())


def test_a_hybrid_stack_converts_period_position_j_of_period_n_to_layer_pn_plus_j():
    hybrid = dataclasses.replace(_base_config(), family="hybrid", n_layers=4, attn_period=2)
    assert hybrid.block_period() == ("attn_mlp", "mamba_mlp")
    model = Model(hybrid, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    state = model.state_dict()
    ref = ({k[len("blocks.0."):]: np.stack([state[k].numpy(), state[k.replace("blocks.0.",
                                                                                "blocks.2.")]])
            for k in state if k.startswith("blocks.0.")},
           {k[len("blocks.1."):]: np.stack([state[k].numpy(), state[k.replace("blocks.1.",
                                                                                "blocks.3.")]])
            for k in state if k.startswith("blocks.1.")})
    nested = tuple({} for _ in ref)
    for tree, flat in zip(nested, ref, strict=True):
        for name, arr in flat.items():
            group, _, leaf = name.rpartition(".")
            (tree.setdefault(group, {}) if group else tree)[leaf] = arr
    top = {k: state[k].numpy() for k in ("ln_f", "embed", "unembed")}
    got = model_state_from_reference(hybrid, {"blocks": nested, **top})
    assert sorted(got) == sorted(state)
    assert all(torch.equal(got[k], state[k]) for k in state)


def test_mrope_runs_and_with_equal_ids_equals_plain_rope_bit_for_bit(rng):
    """A token model under M-RoPE: its default positions are arange(T) in
    each of the three components, which is plain RoPE; explicit (B, T, 3)
    ids that differ move the logits; decode takes (pos, pos, pos)."""
    _, cfg = _cfgs("granite-3-8b", rope="mrope")
    model = Model(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    plain = Model(dataclasses.replace(cfg, rope="rope"), device="cpu")
    plain.load_state_dict(model.state_dict())
    tokens = _t(_tokens(rng, cfg, 2, 7)).long()
    got = model(tokens)
    assert torch.equal(got, plain(tokens))
    ids = np.repeat(np.arange(7)[None, :, None], 3, axis=-1).repeat(2, axis=0)
    ids[:, 3:, 1:] += 5
    moved = model({"tokens": tokens, "positions": _t(ids)})
    assert (moved - got).abs().max().item() > 1e-6
    cache, _ = model.prefill(tokens, 12)
    step, _ = model.decode_step(cache, tokens[:, 0], 7)
    _, want = plain.prefill(torch.cat([tokens, tokens[:, :1]], dim=1), 12)
    torch.testing.assert_close(step, want[:, -1], rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("knob", [{"attn_chunk": 4}, {"score_dtype": "bfloat16"},
                                  {"unroll_inner": True}])
def test_xla_attention_knobs_are_refused(rng, knob):
    _, cfg = _cfgs("granite-3-8b", **knob)
    with pytest.raises(ValueError, match="no such knob"):
        Model(cfg, device="cpu")
    p = {k: _t(v) for k, v in _attn_params(rng, cfg).items()}
    with pytest.raises(ValueError, match="no such knob"):
        tl.apply_attention(p, cfg, torch.zeros(1, 3, cfg.d_model),
                           torch.zeros(1, 3, dtype=torch.long))


def test_serve_on_cuda_without_a_card_refuses_in_a_fresh_interpreter():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite-3-8b"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 2, out.stdout + out.stderr
    assert "cuda" in out.stderr.lower()
    assert "[serve]" not in out.stdout
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.serve(arch="granite-3-8b")
