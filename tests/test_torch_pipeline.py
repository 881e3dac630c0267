"""The pod-axis GPipe pipeline (``runtime/pipeline.py``) on gloo worlds of
four ranks, held to the reference's ``gpipe_forward`` and to the sequential
loop, forward and gradient, at rtol = atol = 2e-5.

The inputs come from a numpy seed. The reference runs them in a JAX
subprocess on four host devices (as ``tests/test_distributed.py`` runs its
pipeline), its gradient by ``jax.grad`` of the output's sum through its
``gpipe_forward``; the port runs them in one world of four ranks, each rank
taking the same sum's gradient by autograd; the sequential loop runs here.
A rank's gradient is non-zero only on its own stage's slice, and the ranks'
gradients add up to the loop's. Cases: the reference test's tanh stack (L 8,
d 16, 3 microbatches of 4) over 4 stages; fewer microbatches than stages;
parameters as a dict; a (pod 2, data 2) mesh whose data replicas agree; a
(pod 1, data 4) mesh, one stage, whose hand-off sends nothing; a stack that 4
stages do not divide, which raises; and qwen1.5-0.5b's smoke layers (f32)
through ``stacked_blocks``, 2 stages of one layer, against the model's own
blocks in a loop.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from torch_world import SRC, start_world

TOL = 2e-5
L, D = 8, 16
# name -> (microbatches, rows a microbatch, parameters as a dict, mesh (pod, data))
CASES = {
    "tanh": (3, 4, False, (4, 1)),
    "few_microbatches": (2, 4, False, (4, 1)),
    "pytree": (3, 4, True, (4, 1)),
    "pod_data": (3, 4, False, (2, 2)),
}
QWEN = dict(microbatches=3, batch=2, seq=8)

_REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.runtime.pipeline import gpipe_forward

CASES = {cases!r}
inp = np.load({inputs!r})
out = {{}}

def stage_fn(p, x):
    if isinstance(p, dict):
        return jax.lax.scan(lambda x, wb: (jnp.tanh(x @ wb[0] + wb[1]), None), x,
                            (p["w"], p["b"]))[0]
    return jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, p)[0]

for name, (m, mb, tree, (pod, data)) in CASES.items():
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(pod, data), ("pod", "data"))
    params = {{"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}} if tree else jnp.asarray(inp["w"])
    x = jnp.asarray(inp[name + ".x"])
    f = gpipe_forward(stage_fn, mesh)
    out[name + ".out"] = np.asarray(jax.jit(f)(params, x))
    g = jax.jit(jax.grad(lambda p: f(p, x).sum()))(params)
    out[name + ".grad.w"] = np.asarray(g["w"] if tree else g)
    if tree:
        out[name + ".grad.b"] = np.asarray(g["b"])
np.savez({reference!r}, **out)
"""

_PORT = """
import dataclasses
import numpy as np
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.runtime import build_pod_mesh, gpipe_forward, stacked_blocks

CASES = {cases!r}
QWEN = {qwen!r}
inp = np.load({inputs!r})
out = {{}}

def stage_fn(p, x):
    if isinstance(p, dict):
        for i in range(p["w"].shape[0]):
            x = torch.tanh(x @ p["w"][i] + p["b"][i])
        return x
    for i in range(p.shape[0]):
        x = torch.tanh(x @ p[i])
    return x

def run(name, mesh, params, x, fn=stage_fn):
    leaves = params if isinstance(params, dict) else {{"w": params}}
    for leaf in leaves.values():
        leaf.requires_grad_()
    y = gpipe_forward(fn, mesh)(params, x)
    y.sum().backward()
    out[name + ".out"] = y.detach().numpy()
    for k, leaf in leaves.items():
        out[f"{{name}}.grad.{{k}}"] = leaf.grad.numpy()

meshes = {{shape: build_pod_mesh(*shape, 1) for shape in {{c[3] for c in CASES.values()}} | {{(1, 4), (2, 2)}}}}
for name, (m, mb, tree, shape) in CASES.items():
    params = ({{"w": torch.from_numpy(inp["w"]), "b": torch.from_numpy(inp["b"])}} if tree
              else torch.from_numpy(inp["w"]))
    run(name, meshes[shape], params, torch.from_numpy(inp[name + ".x"]))
    out[name + ".stage"] = meshes[shape].get_local_rank("pod")

# One stage: the hand-off is the identity and issues no point-to-point.
def refuse(*a, **k):
    raise AssertionError("a pipeline of one stage sent or received")
dist.batch_isend_irecv, saved = refuse, dist.batch_isend_irecv
run("one_stage", meshes[(1, 4)], torch.from_numpy(inp["w"]), torch.from_numpy(inp["tanh.x"]))
dist.batch_isend_irecv = saved

try:
    gpipe_forward(stage_fn, meshes[(4, 1)])(torch.from_numpy(inp["w"][:6]),
                                            torch.from_numpy(inp["tanh.x"]))
    out["indivisible"] = "no error"
except ValueError as e:
    out["indivisible"] = str(e)

cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), dtype="float32")
model = Model(cfg, device="cpu", remat=False)
model.init_weights(torch.Generator().manual_seed(0))
stacked, qwen_stage = stacked_blocks(model)
run("qwen", meshes[(2, 2)], stacked, torch.from_numpy(inp["qwen.x"]), qwen_stage)
np.savez(os.path.join(OUT, f"rank{{RANK}}.npz"), **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (inputs, the reference's results, each rank's results)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    cfg = get_smoke_config("qwen1.5-0.5b")
    inputs = {"w": (0.3 * rng.standard_normal((L, D, D))).astype(np.float32),
              "b": (0.3 * rng.standard_normal((L, D))).astype(np.float32),
              "qwen.x": rng.standard_normal((QWEN["microbatches"], QWEN["batch"], QWEN["seq"],
                                             cfg.d_model)).astype(np.float32)}
    for name, (m, mb, _, _) in CASES.items():
        inputs[name + ".x"] = rng.standard_normal((m, mb, D)).astype(np.float32)
    np.savez(tmp / "inputs.npz", **inputs)
    fmt = dict(cases=CASES, qwen=QWEN, inputs=str(tmp / "inputs.npz"),
               reference=str(tmp / "reference.npz"))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REFERENCE.format(**fmt))],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    world = start_world(textwrap.dedent(_PORT.format(**fmt)), 4, tmp)
    try:
        stdout, stderr = ref.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        ref.kill()
        raise
    world.wait(120)
    assert ref.returncode == 0, stdout + stderr
    ranks = [dict(np.load(world.out / f"rank{r}.npz")) for r in range(4)]
    return inputs, dict(np.load(tmp / "reference.npz")), ranks


def _tanh_stack(params, x):
    for i in range(params["w"].shape[0]):
        x = torch.tanh(x @ params["w"][i] + (params["b"][i] if "b" in params else 0))
    return x


def _sequential(inputs, name):
    """The loop over all L layers on every microbatch, and its gradient."""
    tree = CASES[name][2]
    params = {k: torch.from_numpy(inputs[k]).requires_grad_() for k in (("w", "b") if tree
                                                                      else ("w",))}
    y = _tanh_stack(params, torch.from_numpy(inputs[name + ".x"]))
    y.sum().backward()
    return y.detach().numpy(), {k: p.grad.numpy() for k, p in params.items()}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_the_reference_and_the_loop(runs, name):
    inputs, ref, ranks = runs
    seq, _ = _sequential(inputs, name)
    _close(ref[name + ".out"], seq)  # the reference against its own loop
    for r in ranks:  # the result is the same on every rank
        _close(r[name + ".out"], ref[name + ".out"])
        _close(r[name + ".out"], seq)


@pytest.mark.parametrize("name", list(CASES))
def test_gradient_matches_the_reference_and_the_loop(runs, name):
    inputs, ref, ranks = runs
    _, grads = _sequential(inputs, name)
    pod, data = CASES[name][3]
    for k, want in grads.items():
        _close(ref[f"{name}.grad.{k}"], want)  # jax.grad through the reference's pipeline
        for replica in range(data):
            # The ranks of one pipeline (rank = pod · data + replica, model 1).
            members = [ranks[s * data + replica] for s in range(pod)]
            total = sum(m[f"{name}.grad.{k}"] for m in members)
            _close(total, want)
            _close(total, ref[f"{name}.grad.{k}"])
            per = want.shape[0] // pod
            for m in members:  # non-zero only on the rank's own stage's slice
                g, s = m[f"{name}.grad.{k}"], int(m[name + ".stage"])
                outside = np.concatenate([g[:s * per], g[(s + 1) * per:]])
                assert not outside.any(), f"{name}: stage {s}'s gradient outside its slice"
                assert np.abs(g[s * per:(s + 1) * per]).max() > 0


def test_data_replicas_of_a_pod_data_mesh_agree(runs):
    _, _, ranks = runs
    for key in ("pod_data.out", "pod_data.grad.w", "qwen.out", "qwen.grad.mixer.wq"):
        # ranks 0 and 1 hold stage 0 of replicas 0 and 1; ranks 2 and 3 stage 1.
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
        np.testing.assert_array_equal(ranks[2][key], ranks[3][key])


def test_one_stage_sends_nothing_and_is_the_loop(runs):
    inputs, _, ranks = runs
    seq, grads = _sequential(inputs, "tanh")
    for r in ranks:  # each rank a pipeline of its own
        _close(r["one_stage.out"], seq)
        _close(r["one_stage.grad.w"], grads["w"])


def test_a_stack_the_stages_do_not_divide_raises(runs):
    for r in runs[2]:
        msg = str(r["indivisible"])
        assert "does not split into 4 stages" in msg, msg


def test_smoke_qwen_stages_match_the_models_blocks(runs):
    inputs, _, ranks = runs
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), dtype="float32")
    model = Model(cfg, device="cpu", remat=False)
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(inputs["qwen.x"])
    positions = torch.arange(QWEN["seq"]).expand(QWEN["batch"], QWEN["seq"])
    outs = []
    for m in range(QWEN["microbatches"]):
        h = x[m]
        for block in model.blocks:
            h = model._block(block, h, positions)[0]
        outs.append(h)
    want = torch.stack(outs)
    want.sum().backward()
    for r in ranks:
        _close(r["qwen.out"], want.detach().numpy())
    for name in dict(model.blocks[0].named_parameters()):
        grad = np.stack([dict(b.named_parameters())[name].grad.numpy() for b in model.blocks])
        # Stage s (ranks 2s and 2s + 1) holds layer s.
        total = ranks[0][f"qwen.grad.{name}"] + ranks[2][f"qwen.grad.{name}"]
        _close(total, grad)
        assert not ranks[0][f"qwen.grad.{name}"][1].any()
        assert not ranks[2][f"qwen.grad.{name}"][0].any()
