"""The model axis at run time: one train step on a (pod 2, data 2, model 2)
mesh of 8 gloo ranks, held to the reference and to the port's one process, its collectives to the dry run.

For granite-3-8b, mixtral-8x22b, jamba-1.5-large-398b and xlstm-350m (smoke,
f32, remat, seq_shard; ``tests/torch_model_axis.py``) the ranks compute the
loss and every gradient (``loss_fn`` and ``torch.autograd.grad`` over
DTensor parameters and a batch sharded over ``pod`` and ``data``), then
take one AdamW step through ``runtime/steps.py::make_train_step`` (weight
decay 0: the reference decays its stacked per-layer gains, the port does
not; a constant learning rate of 1e-3). Read back whole, the loss, every
gradient and every updated parameter match ``jax.grad`` of the reference's
loss and one step of ``repro.runtime.steps.make_train_step`` on one CPU
device, and the port's one-process run, within 2e-4 + 2e-4·|ref|. On every
rank each leaf whose spec names ``model`` is smaller than whole, and every
attention call took the head rule (``("attention", "local")``). Each
arch's step runs under ``CommLog``: each collective's count and bytes, by
operation and by mesh dim, must be what ``launch/dryrun.py`` traces for
rank 0 of the same mesh, batch and sequence on a ``"fake"`` process group.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as RefAdamW
from repro.runtime.steps import make_train_step as ref_make_train_step
from repro_torch.convert import model_state_from_reference
from repro_torch.optim import AdamW
from repro_torch.runtime.steps import make_train_step
from torch_model_axis import (
    ARCHS,
    DEADLINE,
    LR,
    close,
    configs,
    held_to_the_dry_run,
    n_attention,
    port_model,
    rank_reports,
    reference,
    start_model_axis_world,
    write_inputs,
)

_SCRIPT = """
from repro_torch.optim import AdamW
from repro_torch.runtime import make_train_step

for arch in ARCHS_HERE:
    model, specs, batch, whole_here = placed_model(arch)
    placed = place(batch, batch_pspec)
    params = dict(model.named_parameters())
    ops.dtensor_rules.clear()
    loss, _ = model.loss_fn(placed)
    grads = torch.autograd.grad(loss, list(params.values()))
    opt = AdamW(weight_decay=0.0)
    step = make_train_step(model, opt, lambda step: torch.tensor(LR))
    with CommLog() as mode:
        state, metrics = step(opt.init(params), placed)
    write_comm(mode, f"{arch}-train")
    report(arch, "train", whole_here=whole_here,
           batch_local=list(placed["tokens"].to_local().shape))
    result = {"loss": whole(loss.detach()), "grad_norm": whole(metrics["grad_norm"]),
              "grads": {k: whole(g) for k, g in zip(params, grads)},
              "params": {k: whole(p.detach()) for k, p in params.items()}}
    if RANK == 0:
        torch.save(result, os.path.join(OUT, f"{arch}-train.pt"))
"""


def _reference_side(ref, params, batch, cfg) -> dict:
    """The reference's loss, gradients and one step's parameters, in the
    port's names (one compilation: the gradients and the step together)."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = RefAdamW(weight_decay=0.0)
    step = ref_make_train_step(ref, opt, lambda step: jnp.float32(LR))

    def both(params, batch):
        return (jax.value_and_grad(ref.loss_fn, has_aux=True)(params, batch),
                step(params, opt.init(params), batch))

    ((loss, _), grads), (new_params, _, metrics) = jax.jit(both)(params, jbatch)
    return {"loss": float(loss), "grad_norm": float(metrics["grad_norm"]),
            "grads": model_state_from_reference(cfg, jax.tree.map(np.asarray, grads)),
            "params": model_state_from_reference(cfg, jax.tree.map(np.asarray, new_params))}


def _one_process(arch: str, state: dict, batch: dict) -> dict:
    """The port's own run of the same step, plain tensors, one process."""
    model = port_model(arch, state)
    params = dict(model.named_parameters())
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = model.loss_fn(tbatch)
    grads = torch.autograd.grad(loss, list(params.values()))
    opt = AdamW(weight_decay=0.0)
    _, metrics = make_train_step(model, opt, lambda step: torch.tensor(LR))(
        opt.init(params), tbatch)
    return {"loss": loss.item(), "grad_norm": metrics["grad_norm"].item(),
            "grads": dict(zip(params, grads)),
            "params": {k: p.detach().clone() for k, p in params.items()}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """-> (the world's OUT, {arch: the reference's side}, {arch: the port's
    one-process run}); the world runs while the test computes both."""
    tmp_path = tmp_path_factory.mktemp("model_axis_train")
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    models = {arch: reference(arch) for arch in ARCHS}
    for arch, (_, _, state, batch) in models.items():
        write_inputs(inputs, arch, state, batch)
    running = start_model_axis_world(f"LR = {LR!r}\n" + _SCRIPT, inputs, tmp_path)
    refs, ones = {}, {}
    for arch, (ref, params, state, batch) in models.items():
        refs[arch] = dict(_reference_side(ref, params, batch, configs(arch)[1]), state=state)
        ones[arch] = _one_process(arch, state, batch)
    running.wait(DEADLINE)
    return running.out, refs, ones


def _got(world, arch):
    return torch.load(world[0] / f"{arch}-train.pt", weights_only=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(world, arch):
    got, want = _got(world, arch), world[1][arch]
    close(got["loss"], want["loss"], "loss")
    assert set(got["grads"]) == set(want["grads"])
    for name, g in got["grads"].items():
        close(g, want["grads"][name], name)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_parameter_after_one_adamw_step_matches_the_reference(world, arch):
    got, want = _got(world, arch), world[1][arch]
    close(got["grad_norm"], want["grad_norm"], "grad_norm")
    for name, p in got["params"].items():
        close(p, want["params"][name], name)
        # The step moved it (a constant rate): not a no-op.
        assert not torch.equal(p, world[1][arch]["state"][name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_the_step_matches_the_ports_one_process_run(world, arch):
    got, one = _got(world, arch), world[2][arch]
    close(got["loss"], one["loss"], "loss")
    close(got["grad_norm"], one["grad_norm"], "grad_norm")
    for name in one["grads"]:
        close(got["grads"][name], one["grads"][name], name)
        close(got["params"][name], one["params"][name], name)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_model_axis_splits_and_attention_takes_the_head_rule(world, arch):
    """On every rank no leaf whose spec names ``model`` is whole, the batch
    is the rank's quarter, and each attention call (the gradients' forward
    and recomputation, then the step's) ran on the rank's own heads."""
    n = n_attention(arch)
    for r, rep in enumerate(rank_reports(world[0], arch, "train")):
        assert rep["whole_here"] == [], (r, rep["whole_here"])
        assert rep["batch_local"] == [2, 16], (r, rep["batch_local"])
        assert rep["rules"] == ({"attention/local": 4 * n} if n else {}), (r, rep["rules"])


@pytest.mark.parametrize("arch", ARCHS)
def test_the_dry_runs_train_collectives_match_the_measured_world(world, arch):
    """Each arch's train step on the 8-rank mesh, each collective as
    ``CommLog`` recorded it on rank 0, against the dry run's per-rank trace
    of the same step: count and bytes by operation and by mesh dim."""
    assert held_to_the_dry_run(world[0], arch, "train")
