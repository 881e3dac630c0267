"""The port's recurrent and hybrid models (the block kinds ``mlstm``,
``slstm``, ``mamba_mlp``, ``mamba_moe``; xlstm-350m and jamba-1.5-large-398b)
against the reference, on the CPU.

The reference's own parameters (its ``Model.init``, carried across by
``convert.model_state_from_reference``, which maps its period position j of
period n to the port's layer n·P + j) and the same numpy-seeded tokens go
through both packages, in f32, at the smoke configs (xlstm: 2 layers, one
period of 2; jamba: 8 layers, one period of 8; also 16 layers, two periods,
and 5, the card's cut, a period of 5). Tolerances are the reference's:

- a model's logits at 2e-4 (tests/test_torch_lm.py, attention's);
- decode against teacher forcing at 2e-3 on the prefill logits and 5e-3 on
  the last step (tests/test_models.py:92-112), and each step's logits
  against the reference's decode at 2e-4;
- one train step: the loss at 1e-5 relative, every gradient within
  2e-4 + 2e-4·|ref|, with remat on and off;
- the parameter count against ``param_counts`` within 15%
  (tests/test_models.py:221).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import SyntheticLM as RefSyntheticLM
from repro.launch.serve import serve as ref_serve
from repro.models import Model as RefModel
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.convert import model_state_from_reference
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import Model

ARCHS_HERE = ["xlstm-350m", "jamba-1.5-large-398b"]
LOGIT_TOL = 2e-4
PREFILL_TOL, DECODE_TOL = 2e-3, 5e-3
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4
PARAM_COUNT_RTOL = 0.15


def _cfgs(arch, **changes):
    """The reference's and the port's smoke config, f32, with ``changes``."""
    ref = dataclasses.replace(ref_smoke_config(arch), dtype="float32", **changes)
    port = dataclasses.replace(get_smoke_config(arch), dtype="float32", **changes)
    return ref, port


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=what)


@functools.lru_cache(maxsize=None)
def _reference(arch, seed=0, n_layers=None):
    """The reference's model (remat on, as its default) and parameters,
    built once a worker."""
    changes = {} if n_layers is None else {"n_layers": n_layers}
    rcfg, _ = _cfgs(arch, **changes)
    ref = RefModel(rcfg)
    return ref, ref.init(jax.random.key(seed))


def _models(arch, seed=0, n_layers=None):
    ref, params = _reference(arch, seed, n_layers)
    _, cfg = _cfgs(arch, **({} if n_layers is None else {"n_layers": n_layers}))
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_state_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return ref, params, model


def _tokens(cfg, b, t, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, t)).astype(np.int32)


# ---------------------------------------------------------------------------
# The model: forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_layers", [("xlstm-350m", None), ("jamba-1.5-large-398b", None),
                                           ("jamba-1.5-large-398b", 16),
                                           ("jamba-1.5-large-398b", 5)])
def test_model_forward_matches_reference(arch, n_layers):
    ref, params, model = _models(arch, n_layers=n_layers)
    assert [b.kind for b in model.blocks] == list(model.cfg.block_kinds())
    tokens = _tokens(model.cfg, 2, 32)
    want = jax.jit(ref.forward)(params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = model(_t(tokens).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    _close(got, want, LOGIT_TOL)


def test_block_kinds_and_the_state_dict_keep_the_references_names():
    _, xl = _cfgs("xlstm-350m")
    names = dict(Model(xl, device="cpu").named_parameters())
    assert {"blocks.0.w_up", "blocks.0.b_gates", "blocks.1.r_z", "blocks.1.w_ff2"} <= set(names)
    assert names["blocks.0.w_gates"].dtype == torch.float32
    jb = get_smoke_config("jamba-1.5-large-398b")  # bf16
    model = Model(jb, device="cpu")
    kinds = [b.kind for b in model.blocks]
    assert kinds == ["mamba_mlp", "mamba_moe"] * 2 + ["attn_mlp", "mamba_moe", "mamba_mlp",
                                                     "mamba_moe"]
    names = dict(model.named_parameters())
    assert names["blocks.0.mixer.A_log"].dtype == torch.float32
    assert names["blocks.0.mixer.in_proj"].dtype == torch.bfloat16
    assert {"blocks.1.ffn.router", "blocks.4.mixer.wq", "blocks.7.ln2"} <= set(names)


def _leaves(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}.")
        else:
            yield prefix + name, value


def test_a_mamba_block_without_an_ffn_matches_the_references_block():
    """``Model._block`` and ``Model._decode_block`` against the reference's
    ``_apply_block_full`` and ``_apply_block_step`` for the one block kind
    no config stacks: ``mamba``, a Mamba mixer without an FFN (the other
    kinds run in the smoke models, held to the reference below)."""
    from repro.models import model as rmodel
    from repro_torch.models.model import Block

    kind = "mamba"
    rcfg, cfg = _cfgs("jamba-1.5-large-398b")
    p = rmodel._init_block(kind, jax.random.key(3), rcfg)
    block = Block(cfg, "cpu", kind)
    block.load_state_dict({name: _t(v) for name, v in _leaves(p)})
    model = Model(cfg, device="cpu")
    x = np.random.default_rng(2).normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    positions = jnp.broadcast_to(jnp.arange(8)[None], (2, 8))
    want, want_state = jax.jit(lambda p, x: rmodel._apply_block_full(
        kind, p, rcfg, x, positions, lambda a, _: a, 16))(p, jnp.asarray(x))
    with torch.no_grad():
        got, state = model._block(block, _t(x), _t(positions))
        _close(got, want, LOGIT_TOL)
        for name in want_state:
            _close(state[name], want_state[name], LOGIT_TOL, name)
        want_t, want_state = jax.jit(lambda p, x, c: rmodel._apply_block_step(
            kind, p, rcfg, x, c, jnp.int32(8), positions[:, :1]))(
                p, jnp.asarray(x[:, 0]), want_state)
        got_t = model._decode_block(block, state, _t(x[:, 0]), _t(positions[:, :1]), 8)
    _close(got_t, want_t, LOGIT_TOL)
    for name in want_state:
        _close(state[name], want_state[name], LOGIT_TOL, name)


def test_convert_maps_period_position_j_of_period_n_to_layer_n_times_p_plus_j():
    ref, params, model = _models("jamba-1.5-large-398b", n_layers=16)
    state = model_state_from_reference(model.cfg, jax.tree.map(np.asarray, params))
    for n in range(2):
        for j in (1, 4):
            want = np.asarray(params["blocks"][j]["mixer"]["wo" if j == 4 else "in_proj"][n])
            got = state[f"blocks.{n * 8 + j}.mixer.{'wo' if j == 4 else 'in_proj'}"]
            np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="period"):
        model_state_from_reference(model.cfg, {"blocks": params["blocks"][:2]})


def _decode_against_teacher_forcing(arch, b, t, t0, max_len):
    """The reference's test (tests/test_models.py:92-112) on the port, and
    each step's logits against the reference's decode on the same weights."""
    ref, params, model = _models(arch)
    tokens = _tokens(model.cfg, b, t)
    with torch.no_grad():
        full = model(_t(tokens).long())
    cache, got = model.prefill(_t(tokens[:, :t0]).long(), max_len)
    _close(got, full[:, :t0], PREFILL_TOL)
    ref_cache, want = jax.jit(lambda p, x: ref.prefill(p, x, max_len))(
        params, {"tokens": jnp.asarray(tokens[:, :t0])})
    _close(got, want, LOGIT_TOL)
    step = jax.jit(ref.decode_step)
    for pos in range(t0, t):
        logits, cache = model.decode_step(cache, _t(tokens[:, pos]).long(), pos)
        want, ref_cache = step(params, ref_cache, jnp.asarray(tokens[:, pos]), jnp.int32(pos))
        _close(logits, want, LOGIT_TOL)
    _close(logits, full[:, t - 1], DECODE_TOL)
    return model, cache, ref_cache


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_decode_matches_teacher_forcing_and_the_reference(arch):
    model, cache, ref_cache = _decode_against_teacher_forcing(arch, 2, 16, 8, 32)
    # Each layer's cache entry against the reference's (period position j,
    # period n), state for state.
    period = len(model.cfg.block_period())
    for i, entry in enumerate(cache):
        want = ref_cache[i % period]
        assert sorted(entry) == sorted(want)
        for name, value in entry.items():
            _close(value, np.asarray(want[name])[i // period], LOGIT_TOL, f"layer {i} {name}")


def test_decode_updates_every_entry_in_place():
    _, _, model = _models("jamba-1.5-large-398b")
    tokens = _t(_tokens(model.cfg, 2, 10)).long()
    cache, _ = model.prefill(tokens[:, :8], 16)
    before = [{k: (v.data_ptr(), v.clone()) for k, v in e.items()} for e in cache]
    for pos in (8, 9):
        _, out = model.decode_step(cache, tokens[:, pos], pos)
        assert out is cache
    for entry, old in zip(cache, before, strict=True):
        for name, (ptr, value) in old.items():
            assert entry[name].data_ptr() == ptr
            assert not torch.equal(entry[name], value), name


def test_decode_state_size_is_constant_in_max_len():
    """xLSTM decode state does not grow with context (tests/test_system.py:88);
    jamba's recurrent layers neither, its attention layer's K/V does."""
    def nbytes(cache):
        return sum(v.numel() * v.element_size() for e in cache for v in e.values())

    _, xl = _cfgs("xlstm-350m")
    model = Model(xl, device="cpu")
    assert nbytes(model.init_cache(1, 1024)) == nbytes(model.init_cache(1, 524288))
    assert [sorted(e) for e in model.init_cache(1, 8)] == [["C", "conv", "m", "n"],
                                                           ["c", "h", "m", "n"]]
    _, jb = _cfgs("jamba-1.5-large-398b")
    model = Model(jb, device="cpu")
    short, long = model.init_cache(1, 64), model.init_cache(1, 4096)
    for kind, a, b in zip(jb.block_kinds(), short, long, strict=True):
        if kind.startswith("mamba"):
            assert sorted(a) == ["conv", "h"] and nbytes([a]) == nbytes([b])
        else:
            assert nbytes([b]) == 64 * nbytes([a])


# ---------------------------------------------------------------------------
# Training: one step's loss and every gradient
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_step(arch):
    ref, params = _reference(arch)
    batch = dict(RefSyntheticLM(vocab=ref.cfg.vocab, batch=4, seq=16, seed=1).batch_at(0))
    (loss, _), grads = jax.jit(jax.value_and_grad(ref.loss_fn, has_aux=True))(params, batch)
    return batch, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_one_train_step_loss_and_every_gradient_match_reference(arch, remat):
    _, _, model = _models(arch)
    model.remat = remat
    batch, want, want_g = _reference_step(arch)
    loss, _ = model.loss_fn({k: _t(v) for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), want, rtol=LOSS_RTOL)
    want_g = model_state_from_reference(model.cfg, want_g)
    assert sorted(names) == sorted(want_g)
    for name, g in zip(names, grads, strict=True):
        assert bool(g.abs().max() > 0) and bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS_HERE)
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


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_runs_a_few_steps_and_the_loss_falls(arch):
    out = ttrain.train(arch=arch, smoke=True, steps=12, batch=4, seq=16, lr=3e-3,
                       log_every=0, seed=0, device="cpu")
    assert len(out["losses"]) == 12 and all(np.isfinite(out["grad_norms"]))
    assert out["final_loss"] < out["first_loss"]


# ---------------------------------------------------------------------------
# The configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_parameter_count_matches_param_counts(arch, smoke):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = Model(cfg, device="meta")
    actual = sum(p.numel() for p in model.parameters())
    est = cfg.param_counts()["total"]
    assert abs(est - actual) / actual < PARAM_COUNT_RTOL, (arch, est, actual)


def test_full_configs_match_the_published_numbers():
    """tests/test_models.py:54-79 for the two configs, and jamba's cut."""
    xl, jb = get_config("xlstm-350m"), get_config("jamba-1.5-large-398b")
    assert (xl.n_layers, xl.d_model, xl.n_heads, xl.n_kv_heads, xl.d_ff, xl.vocab) == (
        24, 1024, 4, 4, 0, 50304)
    assert (xl.xlstm_chunk, xl.block_period()) == (0, ("mlstm", "slstm"))
    assert (jb.n_layers, jb.d_model, jb.n_heads, jb.n_kv_heads, jb.d_ff, jb.vocab) == (
        72, 8192, 64, 8, 24576, 65536)
    kinds = jb.block_kinds()
    assert sum(k.startswith("attn") for k in kinds) == 9  # 1:7 attn:mamba
    assert sum(k.endswith("_moe") for k in kinds) == 36  # every other layer
    assert "attn_moe" not in kinds and (jb.n_experts, jb.top_k, jb.rope) == (16, 2, "none")
    cut = dataclasses.replace(jb, n_layers=5)
    cut.validate()
    assert cut.block_period() == ("mamba_mlp", "mamba_moe", "mamba_mlp", "mamba_moe", "attn_mlp")
