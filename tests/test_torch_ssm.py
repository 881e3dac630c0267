"""The port's recurrent mixers (``models/ssm.py``: Mamba, mLSTM, sLSTM)
against the reference's ``repro/models/ssm.py``, on the CPU.

The reference's own parameters (its ``init_*``) and the same numpy-seeded
inputs go through both packages, in f32, at the smoke configs' widths
(Mamba: jamba's smoke, d_model 64, d_inner 128, state 4; the xLSTM pair:
xlstm's smoke, d_model 64, 4 heads). Tolerances:

- each mixer's output and final state, full sequence and one decode step,
  within 2e-4 + 2e-4·|ref|, the model tests' tolerance
  (tests/test_torch_lm.py; attention's, the loosest part of a model);
- the chunked mLSTM against its sequential form at the reference's own
  tolerances (tests/test_perf_knobs.py:104-124): output 2e-4, the state C
  rtol 2e-3 atol 2e-4, m rtol 1e-4 atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import ssm as rssm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import ssm as tssm

TOL = 2e-4
CHUNK_OUT_TOL = 2e-4
CHUNK_C_TOL = (2e-3, 2e-4)  # rtol, atol
CHUNK_M_TOL = (1e-4, 1e-5)


def _cfgs(arch, **changes):
    """The reference's and the port's smoke config, f32, with ``changes``."""
    ref = dataclasses.replace(ref_smoke_config(arch), dtype="float32", **changes)
    port = dataclasses.replace(get_smoke_config(arch), dtype="float32", **changes)
    return ref, port


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=TOL, atol=TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _states_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == torch.float32 or name == "conv", name
        _close(got[name], want[name], what=name)


def _x(cfg, b, t, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(b, t, cfg.d_model)).astype(np.float32)


MIXERS = {
    # name: (arch, reference init, port's apply, reference's apply, port's
    # step, reference's step, port's zero state)
    "mamba": ("jamba-1.5-large-398b", rssm.init_mamba, tssm.apply_mamba, rssm.apply_mamba,
              tssm.step_mamba, rssm.step_mamba, tssm.init_state_mamba),
    "mlstm": ("xlstm-350m", rssm.init_mlstm, tssm.apply_mlstm, rssm.apply_mlstm,
              tssm.step_mlstm, rssm.step_mlstm, tssm.init_state_mlstm),
    "slstm": ("xlstm-350m", rssm.init_slstm, tssm.apply_slstm, rssm.apply_slstm,
              tssm.step_slstm, rssm.step_slstm, tssm.init_state_slstm),
}


def _jit(fn):
    """The reference's function compiled once a config and shape (the
    config is static)."""
    return jax.jit(fn, static_argnums=1)


def _mixer(name, seed=0, **changes):
    arch, rinit, *_ = MIXERS[name]
    rcfg, cfg = _cfgs(arch, **changes)
    p = rinit(jax.random.key(seed), rcfg)
    return rcfg, cfg, p, {k: _t(v) for k, v in p.items()}


# ---------------------------------------------------------------------------
# Full sequence and one decode step, each mixer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [2, 13])
@pytest.mark.parametrize("name", list(MIXERS))
def test_apply_matches_reference_output_and_final_state(name, t):
    """T = 2 is shorter than the conv's window (ssm_conv 4): the decode
    tail is padded at the front."""
    _, _, tapply, rapply, *_ = MIXERS[name]
    rcfg, cfg, p, tp = _mixer(name)
    x = _x(cfg, 2, t)
    want, want_state = _jit(rapply)(p, rcfg, jnp.asarray(x))
    got, got_state = tapply(tp, cfg, _t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    _close(got, want)
    if name != "mamba":  # the xLSTM blocks add their input: compare what they add too
        _close(got - _t(x), np.asarray(want) - x)
    _states_close(got_state, want_state)


@pytest.mark.parametrize("name", list(MIXERS))
def test_step_matches_reference_from_a_prefilled_and_a_zero_state(name):
    _, _, tapply, rapply, tstep, rstep, tstate = MIXERS[name]
    rcfg, cfg, p, tp = _mixer(name)
    x = _x(cfg, 2, 9)
    _, ref_state = _jit(rapply)(p, rcfg, jnp.asarray(x[:, :8]))
    state = {k: _t(v) for k, v in ref_state.items()}
    want, want_state = _jit(rstep)(p, rcfg, jnp.asarray(x[:, 8]), ref_state)
    got, got_state = tstep(tp, cfg, _t(x[:, 8]), state)
    _close(got, want)
    _states_close(got_state, want_state)
    # From the zero state, steps equal the full sequence: the reference's
    # own decode-against-prefill property, on the port.
    state = tstate(cfg, 2, "cpu")
    outs = []
    for i in range(4):
        y, state = tstep(tp, cfg, _t(x[:, i]), state)
        outs.append(y)
    full, full_state = tapply(tp, cfg, _t(x[:, :4]))
    _close(torch.stack(outs, 1), full)
    _states_close(state, full_state)


def test_state_shapes_and_dtypes_match_reference():
    for name, (arch, *_, tstate) in MIXERS.items():
        rcfg = ref_config(arch)
        cfg = get_config(arch)
        want = getattr(rssm, f"init_state_{name}")(rcfg, 3)
        got = tstate(cfg, 3, "cpu")
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in got.items()} == {
            k: (tuple(v.shape), "torch." + str(v.dtype)) for k, v in want.items()}, name
    assert bool((tssm.init_state_slstm(get_config("xlstm-350m"), 1, "cpu")["n"] == 1).all())


# ---------------------------------------------------------------------------
# The chunked mLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_mlstm_matches_the_references_chunked_form(chunk):
    rcfg, cfg, p, tp = _mixer("mlstm", xlstm_chunk=chunk)
    x = _x(cfg, 2, 32)
    want, want_state = _jit(rssm.apply_mlstm)(p, rcfg, jnp.asarray(x))
    got, got_state = tssm.apply_mlstm(tp, cfg, _t(x))
    _close(got, want)
    _close(got - _t(x), np.asarray(want) - x)
    _states_close(got_state, want_state)


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_mlstm_equals_the_sequential_form(chunk):
    """tests/test_perf_knobs.py:104-124 on the port."""
    _, cfg, _, tp = _mixer("mlstm")
    x = _t(_x(cfg, 2, 32))
    out_seq, st_seq = tssm.apply_mlstm(tp, cfg, x)
    out_ch, st_ch = tssm.apply_mlstm(tp, dataclasses.replace(cfg, xlstm_chunk=chunk), x)
    _close(out_ch, out_seq, CHUNK_OUT_TOL, CHUNK_OUT_TOL)
    _close(out_ch - x, out_seq - x, CHUNK_OUT_TOL, CHUNK_OUT_TOL)
    _close(st_ch["C"], st_seq["C"], *CHUNK_C_TOL)
    _close(st_ch["m"], st_seq["m"], *CHUNK_M_TOL)


@pytest.mark.parametrize("t", [30, 16])
def test_chunked_mlstm_runs_only_where_the_reference_runs_it(t):
    """Chunked only when L divides T and T > L (``repro/models/ssm.py:300``):
    otherwise the sequential scan runs, bit for bit."""
    _, cfg, _, tp = _mixer("mlstm")
    x = _t(_x(cfg, 1, t))
    seq, _ = tssm.apply_mlstm(tp, cfg, x)
    got, _ = tssm.apply_mlstm(tp, dataclasses.replace(cfg, xlstm_chunk=t if t == 16 else 4), x)
    assert torch.equal(got, seq)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MIXERS))
@pytest.mark.parametrize("smoke", [True, False])
def test_init_shapes_and_dtypes_match_reference(name, smoke):
    """The published widths in bf16 (f32 where the reference keeps f32:
    Mamba's A_log, D, dt_b; the mLSTM's gates; the sLSTM's recurrence)."""
    arch, rinit, *_ = MIXERS[name]
    rcfg = ref_smoke_config(arch) if smoke else ref_config(arch)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    want = jax.eval_shape(lambda: rinit(jax.random.key(0), rcfg))
    got = getattr(tssm, f"init_{name}")(None, cfg)
    assert all(v.device.type == "meta" for v in got.values())
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in got.items()} == {
        k: (tuple(v.shape), "torch." + str(v.dtype)) for k, v in want.items()}


def test_init_draws_the_references_distributions():
    _, cfg = _cfgs("jamba-1.5-large-398b")
    gen = torch.Generator().manual_seed(0)
    p = tssm.init_mamba(gen, cfg)
    assert torch.equal(p["A_log"], torch.log(torch.arange(1.0, cfg.ssm_state + 1)).repeat(
        cfg.d_inner, 1))
    assert p["conv_w"].std().item() == pytest.approx(0.1, rel=0.2)
    assert p["dt_b"][0].item() == pytest.approx(np.log(np.expm1(0.01)), rel=1e-6)
    _, cfg = _cfgs("xlstm-350m")
    m = tssm.init_mlstm(gen, cfg)
    assert torch.equal(m["b_gates"][cfg.xlstm_heads:], torch.linspace(3.0, 6.0, cfg.xlstm_heads))
    s = tssm.init_slstm(gen, cfg)
    d = cfg.d_model
    assert torch.equal(s["b"][2 * d:3 * d], torch.full((d,), 3.0))
    assert float(s["b"][:2 * d].abs().sum() + s["b"][3 * d:].abs().sum()) == 0.0
    assert tuple(tssm.init_slstm(None, get_config("xlstm-350m"))["w_ff1"].shape) == (1024, 1408)
