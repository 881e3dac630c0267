"""The port's optimizer substrate (``repro_torch.optim``) against the
reference's (``repro.optim``), on the CPU.

The same numpy-seeded values go to both packages. Tolerances: the schedule
at 1e-7 relative (both compute in f32, operation for operation), plus
peak_lr·2^-24 absolute: XLA's f32 cosine is one ulp (2^-24 near 1) off
torch's on some arguments (cos(0.02π) 0.99756408 against 0.99756402), and
the cosine enters the rate scaled by (1 - final_fraction)·0.5·peak_lr, under
peak_lr; near the end of the decay that one ulp is up to 1.9e-7 of the
rate. The global
norm and the clipped leaves at 1e-6 (f32 sums of squares added in another
order: the reference sums each block leaf stacked over the layers, the
port one tensor at a time); one AdamW update at the reference's own 1e-5
(tests/test_optim.py:11-50), moments stored in bf16 at one bf16 rounding
(2^-8 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as RefAdamW
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import global_norm as ref_global_norm
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro_torch.optim import AdamW, AdamWState, ErrorFeedbackInt8, clip_by_global_norm
from repro_torch.optim import global_norm, warmup_cosine


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    shapes = {"a.w": (8, 5), "b.bias": (5,), "c.gain": (7,), "d.w": (3, 4, 2)}
    return {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}


def _t(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("peak,warmup,total", [(1.0, 10, 100), (3e-4, 5, 40), (1e-3, 1, 7),
                                               (2e-3, 0, 25)])
def test_warmup_cosine_matches_reference(peak, warmup, total):
    steps = np.arange(total + 3, dtype=np.int32)
    want = np.array([float(ref_warmup_cosine(jnp.int32(s), peak_lr=peak, warmup_steps=warmup,
                                             total_steps=total)) for s in steps], np.float32)
    got = np.array([warmup_cosine(torch.tensor(s, dtype=torch.int32), peak_lr=peak,
                                  warmup_steps=warmup, total_steps=total).item()
                    for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=peak * 2.0**-24)
    # The warmup has no cosine: equal there.
    np.testing.assert_array_equal(got[:warmup], want[:warmup])
    out = warmup_cosine(torch.tensor(3, dtype=torch.int32), peak_lr=peak, warmup_steps=warmup,
                        total_steps=total)
    assert out.dtype == torch.float32 and out.dim() == 0


@pytest.mark.parametrize("max_norm", [0.5, 5.0, 1e4])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _tree(1, scale=0.7)
    want_leaves, want_norm = ref_clip(_j(tree), max_norm)
    got_leaves, got_norm = clip_by_global_norm(_t(tree), max_norm)
    np.testing.assert_allclose(got_norm.item(), float(want_norm), rtol=1e-6)
    np.testing.assert_allclose(global_norm(_t(tree)).item(), float(ref_global_norm(_j(tree))),
                               rtol=1e-6)
    for k in tree:
        assert got_leaves[k].dtype == torch.float32
        np.testing.assert_allclose(got_leaves[k].numpy(), np.asarray(want_leaves[k]),
                                   rtol=1e-6, atol=1e-6)


def test_clip_keeps_each_leaf_dtype():
    tree = {"w": torch.ones(4, dtype=torch.bfloat16) * 3, "b": torch.ones(4) * 4}
    clipped, norm = clip_by_global_norm(tree, 5.0)
    assert abs(norm.item() - 10.0) < 1e-5
    assert clipped["w"].dtype == torch.bfloat16 and clipped["b"].dtype == torch.float32
    assert abs(global_norm(clipped).item() - 5.0) < 1e-2


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 6])
def test_adamw_update_matches_reference(moment_dtype, step):
    """One update from the same params, grads and state (random moments at
    ``step``); weight decay on the matrices only."""
    params, grads = _tree(2), _tree(3, scale=0.1)
    m, v = _tree(4, scale=0.01), {k: np.abs(a) for k, a in _tree(5, scale=1e-3).items()}
    ref = RefAdamW(weight_decay=0.1, moment_dtype=moment_dtype)
    mdt = jnp.dtype(moment_dtype)
    ref_state = dataclasses.replace(
        ref.init(_j(params)), step=jnp.int32(step),
        m={k: jnp.asarray(a).astype(mdt) for k, a in m.items()},
        v={k: jnp.asarray(a).astype(mdt) for k, a in v.items()})
    want_p, want_s = ref.update(_j(grads), ref_state, _j(params), lr=jnp.float32(3e-3))

    opt = AdamW(weight_decay=0.1, moment_dtype=moment_dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moment_dtype]
    state = AdamWState(step=torch.tensor(step, dtype=torch.int32),
                       m={k: t.to(tdt) for k, t in _t(m).items()},
                       v={k: t.to(tdt) for k, t in _t(v).items()})
    got_p = _t(params)
    out = opt.update(_t(grads), state, got_p, torch.tensor(3e-3, dtype=torch.float32))
    assert out is state and int(state.step) == int(want_s.step) == step + 1
    mtol = 1e-5 if moment_dtype == "float32" else 2.0**-8
    for k in params:
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]), rtol=1e-5, atol=1e-7)
        for got, want in ((state.m[k], want_s.m[k]), (state.v[k], want_s.v[k])):
            assert got.dtype == tdt
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want.astype(jnp.float32)), rtol=mtol, atol=1e-9)


def test_adamw_matches_hand_computed_adam():
    """tests/test_optim.py's hand-computed update, on the port."""
    opt = AdamW(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    p = {"w": torch.tensor([1.0, -2.0])}
    s = opt.init(p)
    assert s.step.dtype == torch.int32 and int(s.step) == 0
    opt.update({"w": torch.tensor([0.5, 0.25])}, s, p, lr=0.1)
    want = np.array([1.0, -2.0]) - 0.1 * np.array([0.5, 0.25]) / (
        np.sqrt(np.array([0.25, 0.0625])) + 1e-8)
    np.testing.assert_allclose(p["w"].numpy(), want, rtol=1e-5)
    assert int(s.step) == 1


def test_adamw_decays_matrices_only_and_keeps_param_dtype():
    opt = AdamW(weight_decay=0.1)
    p = {"mat": torch.ones(2, 2, dtype=torch.bfloat16), "vec": torch.ones(2)}
    s = opt.init(p)
    opt.update({k: torch.zeros_like(t) for k, t in p.items()}, s, p, lr=torch.tensor(0.1))
    assert p["mat"].dtype == torch.bfloat16 and float(p["mat"][0, 0]) < 1.0
    assert float(p["vec"][0]) == 1.0


def test_adamw_bf16_moments_track_f32():
    opt32, opt16 = AdamW(weight_decay=0.0), AdamW(moment_dtype="bfloat16", weight_decay=0.0)
    p32, p16 = {"w": torch.ones(16)}, {"w": torch.ones(16)}
    s32, s16 = opt32.init(p32), opt16.init(p16)
    assert s16.m["w"].dtype == torch.bfloat16
    for i in range(10):
        g = {"w": torch.full((16,), 0.1 * (i + 1))}
        opt32.update(g, s32, p32, lr=0.01)
        opt16.update(g, s16, p16, lr=0.01)
    np.testing.assert_allclose(p32["w"].numpy(), p16["w"].numpy(), rtol=0.05)


def test_unknown_moment_dtype_and_compression_raise():
    with pytest.raises(ValueError, match="moment_dtype"):
        AdamW(moment_dtype="float16").init({"w": torch.ones(2)})
    # Compression reduces over a process group: outside one it raises, and
    # its error state is one f32 zero tensor a leaf.
    comp = ErrorFeedbackInt8()
    err = comp.init({"w": torch.ones(2, 3, dtype=torch.bfloat16)})
    assert err["w"].dtype == torch.float32 and not err["w"].any()
    with pytest.raises(ValueError, match="process group"):
        comp.reduce_mean({"w": torch.ones(2, 3)}, err)


def test_reference_optimizer_still_traces():
    """The reference's update under jit, as the port's tests above call it
    eagerly: the comparison is of the same function."""
    ref = RefAdamW()
    p = _j(_tree(6))
    new_p, s = jax.jit(ref.update)(p, ref.init(p), p, jnp.float32(1e-3))
    assert int(s.step) == 1 and set(new_p) == set(p)
