"""The port's training path (``repro_torch.{models,optim,runtime,data,launch}``)
against the reference's, on the CPU.

Weights come from the reference's ``Model.init`` through
``convert.model_state_from_reference``, batches from the reference's
``SyntheticLM`` (``jax.random``; the port's own stream draws from numpy),
so both packages see the same values. Attention takes the kernel route
(``force_impl("kernel")``: on CPU tensors its plain forward under
``FlashAttentionFunction``, whose backward is ``attention_bwd_torch``) or
the plain route, as each test says.

Tolerances, each with its reason:

- the loss at 1e-5 relative, every gradient at 1e-4 absolute (f32 sums in
  another order; the gradients' largest entries are ~0.2);
- five train steps: losses, parameters and moments at 1e-4;
- ``accum=2`` against ``accum=1`` at rtol 1e-3, atol 1e-5, the
  reference's own bound (tests/test_optim.py:102);
- attention's backward in f32 at 1e-5 of the largest gradient; in bf16
  against the f32 gradient of the same bf16 inputs at one bf16 rounding
  (2^-8 relative) plus 1e-5 of the largest;
- an interrupted and resumed ``train`` equals the uninterrupted one bit for
  bit, the reference's contract (tests/test_train_resume.py).

Weight decay: the port decays tensors of two or more dimensions, so each
layer's norm gains and QKV biases (1-D) are exempt, as the reference's own
comment intends. The reference stacks those leaves over the layers, which
makes them 2-D, and decays them (ROADMAP.md queue 3). The multi-step
comparisons therefore run with ``weight_decay=0``, and one test pins the
difference leaf by leaf.
"""

import dataclasses
import functools
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import SyntheticEmbeds as RefSyntheticEmbeds
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import Model as RefModel
from repro.optim import AdamW as RefAdamW
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.runtime.elastic import choose_submesh as ref_choose_submesh
from repro.runtime.elastic import plan_remesh as ref_plan_remesh
from repro.runtime.steps import make_train_step as ref_make_train_step
from repro.runtime.straggler import StragglerMonitor as RefStragglerMonitor
from repro_torch.configs import get_smoke_config
from repro_torch.convert import adamw_state_from_reference, model_state_from_reference
from repro_torch.data import Prefetch, SyntheticEmbeds, SyntheticLM
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch import train as ttrain
from repro_torch.models import Model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.runtime import StragglerMonitor, choose_submesh, make_eval_step
from repro_torch.runtime import make_train_step, plan_remesh
from repro_torch.runtime.elastic import build_mesh

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen1.5-0.5b"
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-4
STEP_TOL = 1e-4


def _pair(arch=ARCH, seed=0):
    """(reference model, its params, the port's model with those weights),
    the smoke config in f32."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    ref = RefModel(rcfg, remat=False)
    params = ref.init(jax.random.key(seed))
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_state_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return ref, params, model


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_tree(model, tree) -> dict:
    return model_state_from_reference(model.cfg, jax.tree.map(np.asarray, tree))


def _route(route: str):
    return ops.force_impl(route)


# ---------------------------------------------------------------------------
# The loss and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("route", ["kernel", "ref"])
def test_loss_and_gradients_match_reference(route, masked):
    ref, params, model = _pair()
    batch = dict(RefSyntheticLM(vocab=model.cfg.vocab, batch=4, seq=16, seed=1).batch_at(0))
    if masked:
        batch["loss_mask"] = (np.random.default_rng(0).random((4, 16)) < 0.7).astype(np.float32)
    (want, want_m), want_g = jax.value_and_grad(ref.loss_fn, has_aux=True)(params, batch)
    before = tfa.backward_calls["attention_bwd_torch"]
    with _route(route):
        loss, metrics = model.loss_fn(_torch_batch(batch))
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
    # The kernel route's backward ran once a layer; the plain route never.
    calls = tfa.backward_calls["attention_bwd_torch"] - before
    assert calls == (model.cfg.n_layers if route == "kernel" else 0)
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    assert metrics["tokens"].item() == float(want_m["tokens"])
    want_g = _port_tree(model, want_g)
    assert sorted(names) == sorted(want_g)
    for name, g in zip(names, grads, strict=True):
        assert bool(g.abs().max() > 0), name
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), rtol=0, atol=GRAD_ATOL,
                                   err_msg=name)


def test_remat_changes_no_value():
    _, _, model = _pair()
    batch = _torch_batch(RefSyntheticLM(vocab=model.cfg.vocab, batch=2, seq=8).batch_at(3))
    out = {}
    for remat in (False, True):
        model.remat = remat
        with _route("kernel"):
            loss, _ = model.loss_fn(batch)
            out[remat] = (loss, torch.autograd.grad(loss, list(model.parameters())))
    assert out[True][0].item() == out[False][0].item()
    for a, b in zip(out[True][1], out[False][1], strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_eval_step_is_the_loss_without_a_graph():
    _, _, model = _pair()
    batch = _torch_batch(RefSyntheticLM(vocab=model.cfg.vocab, batch=2, seq=8).batch_at(0))
    metrics = make_eval_step(model)(batch)
    assert metrics["loss"].grad_fn is None
    assert metrics["loss"].item() == model.loss_fn(batch)[0].item()


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


def _schedules(steps=40):
    kw = dict(peak_lr=5e-3, warmup_steps=2, total_steps=steps)
    return functools.partial(ref_warmup_cosine, **kw), functools.partial(warmup_cosine, **kw)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-3-8b"])
def test_five_train_steps_match_reference(arch):
    ref, params, model = _pair(arch)
    ref_sched, sched = _schedules()
    ref_opt, opt = RefAdamW(weight_decay=0.0), AdamW(weight_decay=0.0)
    ref_step = jax.jit(ref_make_train_step(ref, ref_opt, ref_sched))
    step = make_train_step(model, opt, sched)
    ref_state, state = ref_opt.init(params), opt.init(dict(model.named_parameters()))
    data = RefSyntheticLM(vocab=model.cfg.vocab, batch=4, seq=16, seed=2)
    for i in range(5):
        batch = data.batch_at(i)
        params, ref_state, want = ref_step(params, ref_state, batch)
        with _route("kernel"):
            state, got = step(state, _torch_batch(batch))
        for key in ("loss", "grad_norm", "lr"):
            assert got[key].dim() == 0 and got[key].dtype == torch.float32
            np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=STEP_TOL,
                                       err_msg=key)
    want_p = _port_tree(model, params)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_p[name].numpy(), rtol=0, atol=STEP_TOL,
                                   err_msg=name)
    want_s = adamw_state_from_reference(model.cfg, jax.tree.map(np.asarray, ref_state))
    assert int(state.step) == int(want_s.step) == 5 and state.step.dtype == torch.int32
    for moments, want in ((state.m, want_s.m), (state.v, want_s.v)):
        for name, t in moments.items():
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0, atol=STEP_TOL,
                                       err_msg=name)


def test_weight_decay_exempts_each_layers_gains_and_biases():
    """One step with decay from the same state: equal to the reference's on
    every leaf but the per-layer norm gains and QKV biases, which the
    reference (its leaves stacked, so 2-D) decays by lr·wd·p and the port
    does not."""
    ref, params, model = _pair()
    ref_sched, sched = _schedules()
    ref_opt, opt = RefAdamW(), AdamW()
    batch = RefSyntheticLM(vocab=model.cfg.vocab, batch=4, seq=16).batch_at(0)
    ref_state = dataclasses.replace(ref_opt.init(params), step=jnp.int32(5))
    state = opt.init(dict(model.named_parameters()))
    state.step.fill_(5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    new, ref_state, want = ref_make_train_step(ref, ref_opt, ref_sched)(params, ref_state, batch)
    with _route("kernel"):
        state, got = make_train_step(model, opt, sched)(state, _torch_batch(batch))
    lr = got["lr"].item()
    want_p = _port_tree(model, new)
    exempt = {"ln1", "ln2", "bq", "bk", "bv"}
    for name, p in model.state_dict().items():
        shift = 0.0
        if name.split(".")[-1] in exempt and name.startswith("blocks."):
            assert p.dim() == 1
            shift = -lr * ref_opt.weight_decay * before[name].numpy()
            if name.endswith(("ln1", "ln2")):  # gains of 1: a shift the check resolves
                assert np.abs(shift).min() > 4 * STEP_TOL
        elif p.dim() >= 2:
            assert not np.array_equal(p.numpy(), before[name].numpy())
        np.testing.assert_allclose(want_p[name].numpy() - shift, p.numpy(), rtol=0,
                                   atol=STEP_TOL, err_msg=name)


def test_accumulation_matches_the_full_batch():
    _, _, model = _pair()
    _, sched = _schedules()
    data = RefSyntheticLM(vocab=model.cfg.vocab, batch=8, seq=16)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    for accum in (1, 2):
        model.load_state_dict(base)
        opt = AdamW()
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(model, opt, sched, accum=accum)
        with _route("kernel"):
            for i in range(3):
                state, metrics = step(state, _torch_batch(data.batch_at(i)))
        out[accum] = ({k: v.clone() for k, v in model.state_dict().items()}, metrics)
    assert out[2][1]["tokens"].item() == 0.0  # as the reference's accumulated step
    for name, p in out[1][0].items():
        np.testing.assert_allclose(out[2][0][name].numpy(), p.numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Attention's backward
# ---------------------------------------------------------------------------

# B, Hq, Hkv, T, S, D, causal, window
ATTN_CASES = [
    (2, 4, 4, 16, 16, 16, True, None),   # MHA causal prefill
    (2, 8, 2, 24, 24, 16, True, None),   # GQA, group 4
    (1, 4, 2, 20, 20, 8, True, 6),       # causal sliding window
    (2, 4, 1, 9, 30, 16, False, 11),     # non-causal window, T < S
    (1, 2, 2, 7, 19, 8, True, None),     # T < S causal
    (1, 6, 3, 1, 13, 16, False, None),   # one query over a cache
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_backward_matches_autograd_of_the_plain_version(case, dtype, monkeypatch):
    b, hq, hkv, t, s, d, causal, window = case
    # Small blocks, so the cases span several query blocks and key ranges.
    monkeypatch.setattr(tfa, "BWD_BLOCK_BYTES", b * hq * s * 4 * 4)
    rng = np.random.default_rng(hash(case) % 2**32)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
                     for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, t, d)))
    opts = dict(causal=causal, window=window)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = tfa.backward_calls["attention_bwd_torch"]
    out = ops.attention(q, k, v, mode="kernel", **opts)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert tfa.backward_calls["attention_bwd_torch"] == before + 1
    # The gradient of the plain version, in f32 from the same inputs.
    q32, k32, v32 = (x.detach().float().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(attention_ref(q32, k32, v32, **opts), (q32, k32, v32),
                               dout.float())
    for name, g, w in zip("qkv", got, want, strict=True):
        assert g.dtype == dtype and g.shape == w.shape
        scale = w.abs().max().item()
        rtol = 0.0 if dtype == torch.float32 else 2.0**-8
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=rtol, atol=1e-5 * scale,
                                   err_msg=f"d{name}")


def test_attention_takes_the_function_only_where_a_gradient_is_wanted():
    q = torch.randn(1, 2, 4, 8, requires_grad=True)
    k, v = torch.randn(1, 2, 4, 8), torch.randn(1, 2, 4, 8)
    assert ops.attention(q, k, v, mode="kernel").grad_fn is not None
    with torch.no_grad():
        assert ops.attention(q, k, v, mode="kernel").grad_fn is None
    with torch.inference_mode():
        assert ops.attention(q.detach(), k, v, mode="kernel").grad_fn is None
    # No input wants a gradient: the direct path.
    assert ops.attention(q.detach(), k, v, mode="kernel").grad_fn is None
    # A batched call keeps its batching rule.
    out = torch.vmap(lambda x: ops.attention(x, k, v, mode="kernel"))(q.detach()[None])
    torch.testing.assert_close(out[0], attention_ref(q.detach(), k, v))


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def test_synthetic_lm_is_the_reference_stream_from_numpy():
    data = SyntheticLM(vocab=1000, batch=6, seq=300, seed=4)
    a = data.batch_at(7)
    b = SyntheticLM(vocab=1000, batch=6, seq=300, seed=4).batch_at(7)
    for key in ("tokens", "labels"):
        assert a[key].dtype == np.int32 and a[key].shape == (6, 300)
        np.testing.assert_array_equal(a[key], b[key])
    assert not np.array_equal(a["tokens"], data.batch_at(8)["tokens"])
    assert not np.array_equal(a["tokens"], SyntheticLM(1000, 6, 300, seed=5).batch_at(7)["tokens"])
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    # x_{t+1} = (31 x_t + 7 + n) mod min(V, 257), n in {0, 1}, n = 1 about a tenth.
    x, y = a["tokens"].astype(np.int64), a["labels"].astype(np.int64)
    n = (y - (31 * x + 7)) % 257
    assert set(np.unique(n)) <= {0, 1} and x.max() < 257
    assert 0.07 < n.mean() < 0.13
    # The reference's stream has the same law.
    r = RefSyntheticLM(vocab=1000, batch=6, seq=300, seed=4).batch_at(7)
    rn = (np.asarray(r["labels"]) - (31 * np.asarray(r["tokens"]) + 7)) % 257
    assert set(np.unique(rn)) <= {0, 1}
    small = SyntheticLM(vocab=100, batch=2, seq=50).batch_at(0)
    assert small["tokens"].max() < 100


@pytest.mark.parametrize("mrope", [False, True])
def test_synthetic_embeds_batches_as_the_reference_lays_them_out(mrope):
    """The reference's fields, shapes and laws (standard-normal f32
    embeddings, uniform labels, arange positions in each component under
    M-RoPE), drawn from numpy: a pure function of (seed, step)."""
    data = SyntheticEmbeds(d_model=8, vocab=16, batch=3, seq=500, mrope=mrope, seed=2)
    ref = RefSyntheticEmbeds(d_model=8, vocab=16, batch=3, seq=500, mrope=mrope, seed=2)
    a, r = data.batch_at(4), ref.batch_at(4)
    assert sorted(a) == sorted(r) == sorted(["embeds", "labels"] + ["positions"] * mrope)
    for name in a:
        assert a[name].shape == tuple(r[name].shape), name
    assert a["embeds"].dtype == np.float32 and a["labels"].dtype == np.int32
    assert abs(a["embeds"].mean()) < 0.05 and 0.95 < a["embeds"].std() < 1.05
    assert a["labels"].min() == 0 and a["labels"].max() == 15
    if mrope:
        assert a["positions"].dtype == np.int32
        np.testing.assert_array_equal(a["positions"], np.asarray(r["positions"]))
    again = data.batch_at(4)
    assert all(np.array_equal(a[k], again[k]) for k in a)
    assert not np.array_equal(a["embeds"], data.batch_at(5)["embeds"])


def test_prefetch_order_backpressure_and_close():
    calls = []
    lock = threading.Lock()

    def batch_at(step):
        with lock:
            calls.append(step)
        return {"x": np.full((2,), step, np.int32)}

    pf = Prefetch(batch_at, start_step=3, depth=2, device="cpu")
    it = iter(pf)
    got = [next(it) for _ in range(3)]
    assert [s for s, _ in got] == [3, 4, 5]
    assert all(isinstance(b["x"], torch.Tensor) and int(b["x"][0]) == s for s, b in got)
    time.sleep(0.5)
    # Backpressure: at most depth batches wait, plus one the worker holds.
    with lock:
        assert max(calls) <= 5 + 2 + 1
    pf.close()
    assert not pf._thread.is_alive()
    # Over a data mesh (a stand-in for rank 1 of 2; real worlds are in
    # tests/test_torch_dp.py), a rank gets its rows of each leaf, and a leaf
    # whose batch the ranks do not divide raises.
    class _RankOneOfTwo:
        def get_local_rank(self):
            return 1

        def size(self):
            return 2

    pf = Prefetch(lambda step: {"x": np.arange(4) + 10 * step, "y": np.arange(6)},
                  sharding=_RankOneOfTwo(), device="cpu")
    step, b = next(iter(pf))
    assert step == 0 and b["x"].tolist() == [2, 3] and b["y"].tolist() == [3, 4, 5]
    pf.close()
    pf = Prefetch(lambda step: {"x": np.arange(4), "odd": np.arange(3)},
                  sharding=_RankOneOfTwo(), device="cpu")
    with pytest.raises(RuntimeError, match="prefetch") as info:
        next(iter(pf))
    assert isinstance(info.value.__cause__, ValueError)
    assert "'odd'" in str(info.value.__cause__) and "2 ranks" in str(info.value.__cause__)
    pf.close()


def test_prefetch_raises_what_its_thread_raised():
    def batch_at(step):
        if step == 1:
            raise ValueError("no batch 1")
        return {"x": np.zeros(2, np.int32)}

    pf = Prefetch(batch_at, device="cpu")
    it = iter(pf)
    assert next(it)[0] == 0
    with pytest.raises(RuntimeError, match="prefetch") as info:
        next(it)
    assert isinstance(info.value.__cause__, ValueError)
    pf.close()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


def test_resume_is_bit_exact(tmp_path):
    common = dict(arch=ARCH, smoke=True, batch=4, seq=16, lr=1e-3, save_every=5,
                  log_every=0, seed=3, device="cpu")
    full = ttrain.train(steps=10, checkpoint_dir=str(tmp_path / "a"), **common)
    ttrain.train(steps=10, stop_after=5, checkpoint_dir=str(tmp_path / "b"), **common)
    resumed = ttrain.train(steps=10, checkpoint_dir=str(tmp_path / "b"), resume=True, **common)
    assert resumed["steps"] == 5 and resumed["restore_s"] is not None
    assert resumed["losses"] == full["losses"][5:]
    for name, p in full["params"].items():
        torch.testing.assert_close(resumed["params"][name], p, rtol=0, atol=0)
    for a, b in ((full["opt_state"].m, resumed["opt_state"].m),
                 (full["opt_state"].v, resumed["opt_state"].v)):
        for name in a:
            torch.testing.assert_close(b[name], a[name], rtol=0, atol=0)
    assert int(full["opt_state"].step) == int(resumed["opt_state"].step) == 10


def test_resume_from_an_in_loop_async_checkpoint_is_bit_exact(tmp_path, monkeypatch):
    """The async save at step 3 is held until the loop has run steps 4 and 5,
    which update the parameters and moments in place; the step-5 save is then
    removed, and the run resumed from step 3 equals the uninterrupted one."""
    from repro_torch.checkpoint import Checkpointer

    common = dict(arch=ARCH, smoke=True, batch=4, seq=16, lr=1e-3, save_every=3,
                  log_every=0, seed=3, device="cpu")
    full = ttrain.train(steps=8, checkpoint_dir=str(tmp_path / "a"), **common)

    release = threading.Event()
    caller = threading.current_thread()
    makedirs, wait = os.makedirs, Checkpointer.wait

    def held(*args, **kwargs):
        if threading.current_thread() is not caller:
            assert release.wait(60), "the writer was never released"
        return makedirs(*args, **kwargs)

    def released_wait(self):
        if self._thread is not None:
            release.set()
        wait(self)

    monkeypatch.setattr(os, "makedirs", held)
    monkeypatch.setattr(Checkpointer, "wait", released_wait)
    ttrain.train(steps=8, stop_after=5, checkpoint_dir=str(tmp_path / "b"), **common)
    monkeypatch.undo()
    assert release.is_set()
    ck = Checkpointer(str(tmp_path / "b"))
    assert ck.all_steps() == [3, 5]
    shutil.rmtree(tmp_path / "b" / f"step_{5:010d}")
    resumed = ttrain.train(steps=8, checkpoint_dir=str(tmp_path / "b"), resume=True, **common)
    assert resumed["steps"] == 5
    assert resumed["losses"] == full["losses"][3:]
    for name, p in full["params"].items():
        torch.testing.assert_close(resumed["params"][name], p, rtol=0, atol=0)
    for a, b in ((full["opt_state"].m, resumed["opt_state"].m),
                 (full["opt_state"].v, resumed["opt_state"].v)):
        for name in a:
            torch.testing.assert_close(b[name], a[name], rtol=0, atol=0)
    assert int(full["opt_state"].step) == int(resumed["opt_state"].step) == 8


def test_training_reduces_loss():
    out = ttrain.train(arch="granite-3-8b", smoke=True, steps=25, batch=8, seq=16, lr=2e-3,
                       log_every=0, seed=0, device="cpu")
    assert out["final_loss"] < out["first_loss"] - 0.2
    assert len(out["step_ms"]) == len(out["grad_norms"]) == 25
    assert all(np.isfinite(out["grad_norms"]))


def test_cli_trains_the_smoke_config_on_the_cpu(capsys):
    assert ttrain.main(["--device", "cpu", "--steps", "3", "--mesh"]) == 0
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out and "[train] done: 3 steps" in out


def test_cuda_without_a_card_raises_in_a_fresh_interpreter():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--steps", "2"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2, out.stdout + out.stderr
    assert "cuda" in out.stderr.lower() and "[train] step" not in out.stdout
    code = ("from repro_torch.launch.train import train\n"
            "try:\n    train(arch='qwen1.5-0.5b', steps=1)\n"
            "except RuntimeError as e:\n    print('RAISED', e)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert "RAISED" in out.stdout and "cuda" in out.stdout, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# Straggler monitor and elastic arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold,sustained,ema", [(1.5, 5, 0.05), (1.2, 2, 0.3), (3.0, 1, 0.0)])
def test_straggler_monitor_matches_reference(threshold, sustained, ema):
    rng = np.random.default_rng(int(threshold * 10) + sustained)
    times = np.where(rng.random(300) < 0.2, 4.0, 1.0) * rng.uniform(0.9, 1.1, 300)
    ref = RefStragglerMonitor(threshold=threshold, sustained=sustained, ema=ema)
    port = StragglerMonitor(threshold=threshold, sustained=sustained, ema=ema)
    for dt in times:
        assert port.record(float(dt)) == ref.record(float(dt))
        assert port.baseline == ref.baseline
    assert port.triggered == ref.triggered


def test_submesh_and_remesh_match_reference():
    for n in range(0, 70):
        for model in (1, 2, 4, 8):
            for max_data in (None, 3, 16):
                try:
                    want = ref_choose_submesh(n, model=model, max_data=max_data)
                except ValueError:
                    with pytest.raises(ValueError):
                        choose_submesh(n, model=model, max_data=max_data)
                    continue
                assert choose_submesh(n, model=model, max_data=max_data) == want
    for old in ((8, 1), (16, 2), (4, 4), (32, 8)):
        for surviving in range(old[1], 70, 3):
            got, want = plan_remesh(old, surviving), ref_plan_remesh(old, surviving)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert build_mesh(None, 1, 1) is None
    with pytest.raises(ValueError, match="needs 2 devices, 1 available"):
        build_mesh(None, 2, 1)


def test_a_recomputed_block_takes_the_route_of_its_forward():
    """Autograd runs a CUDA backward on a thread of its own, where
    ``force_impl``'s context variable is unset: a checkpointed block's
    recomputation must still take the route its forward took. Here the
    backward runs on a new thread, outside the context."""
    _, _, model = _pair()
    batch = _torch_batch(RefSyntheticLM(vocab=model.cfg.vocab, batch=2, seq=8).batch_at(1))
    with _route("kernel"):
        loss, _ = model.loss_fn(batch)
        want = torch.autograd.grad(loss, list(model.parameters()))
        loss, _ = model.loss_fn(batch)
    out = {}
    before = tfa.backward_calls["attention_bwd_torch"]
    thread = threading.Thread(
        target=lambda: out.update(g=torch.autograd.grad(loss, list(model.parameters()))))
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive() and "g" in out
    assert tfa.backward_calls["attention_bwd_torch"] == before + model.cfg.n_layers
    for a, b in zip(out["g"], want, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
