"""The model axis at run time: a prefill and decode steps on a (pod 2, data 2,
model 2) mesh of 8 gloo ranks, held to the reference and to the port's one
process; the measured world's collectives against the dry run's rules; the
head rule and the hook in one process.

For granite-3-8b, mixtral-8x22b, jamba-1.5-large-398b and xlstm-350m (smoke,
f32; ``tests/torch_model_axis.py``) the ranks run ``prefill`` of the batch
(placed by ``batch_pspec``) into a cache of 32 positions, a decode step at
position 0 on ``init_cache(8, 32)`` placed by ``cache_pspecs`` (the
reference docstring's step), and a decode step at position 16 on the
prefill's cache, placed by ``cache_pspecs`` too. Read back whole, every
logit matches the reference's (one CPU device) and the port's one-process
run within 2e-4 + 2e-4·|ref|. Prefill attention takes the head rule
(``local``); a decode step's cache is split on head_dim by the
reference's ``cache_pspecs``, so its attention takes the gathered rule, as
expected (the kernel still runs, on the gathered heads).

granite's decode step at position 16 runs under ``CommDebugMode``: each
collective's count must be what ``launch/dryrun.py::collectives`` gives for
the same mesh, batch and sequence (the train step's: the train file).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import Model
from torch_model_axis import (
    ARCHS,
    B,
    COMM_ARCH,
    DEADLINE,
    MAX_LEN,
    T,
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
from torch_world import run_world

_SCRIPT = """
for arch in ARCHS_HERE:
    model, specs, batch, whole_here = placed_model(arch)
    placed = place(batch, batch_pspec)
    first = place({"t": batch["tokens"][:, 0]}, batch_pspec)["t"]
    last = place({"t": batch["labels"][:, -1]}, batch_pspec)["t"]
    ops.dtensor_rules.clear()
    cache, prefill = model.prefill(placed, MAX_LEN)
    report(arch, "prefill", whole_here=whole_here)
    ops.dtensor_rules.clear()
    fresh = model.init_cache(B, MAX_LEN)
    fresh = place(fresh, cache_pspecs)
    at0, _ = model.decode_step(fresh, first, 0)
    cache = place(cache, cache_pspecs)
    with CommDebugMode() as mode:
        at16, _ = model.decode_step(cache, last, T)
    if arch == COMM_ARCH and RANK == 0:
        with open(os.path.join(OUT, "comm-decode.json"), "w") as f:
            json.dump(counts(mode), f)
    report(arch, "decode", cache_specs=[{k: str(v.placements) for k, v in e.items()}
                                        for e in cache])
    result = {"prefill": whole(prefill), "at0": whole(at0), "at16": whole(at16)}
    if RANK == 0:
        torch.save(result, os.path.join(OUT, f"{arch}-serve.pt"))
"""


def _reference_side(ref, params, batch) -> dict:
    """The reference's prefill logits and its two decode steps' logits."""
    jbatch = {"tokens": jnp.asarray(batch["tokens"])}
    cache, prefill = jax.jit(lambda p, b: ref.prefill(p, b, MAX_LEN))(params, jbatch)
    step = jax.jit(ref.decode_step)
    at0, _ = step(params, ref.init_cache(B, MAX_LEN), jnp.asarray(batch["tokens"][:, 0]),
                  jnp.int32(0))
    at16, _ = step(params, cache, jnp.asarray(batch["labels"][:, -1]), jnp.int32(T))
    return {k: np.asarray(v) for k, v in (("prefill", prefill), ("at0", at0), ("at16", at16))}


def _one_process(arch: str, state: dict, batch: dict) -> dict:
    model = port_model(arch, state)
    cache, prefill = model.prefill(torch.from_numpy(batch["tokens"]), MAX_LEN)
    at0, _ = model.decode_step(model.init_cache(B, MAX_LEN),
                               torch.from_numpy(batch["tokens"][:, 0]), 0)
    at16, _ = model.decode_step(cache, torch.from_numpy(batch["labels"][:, -1]), T)
    return {"prefill": prefill, "at0": at0, "at16": at16}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """-> (the world's OUT, {arch: the reference's logits}, {arch: the
    port's one-process logits}); the world runs while the test computes
    both."""
    tmp_path = tmp_path_factory.mktemp("model_axis_decode")
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    models = {arch: reference(arch) for arch in ARCHS}
    for arch, (_, _, state, batch) in models.items():
        write_inputs(inputs, arch, state, batch)
    running = start_model_axis_world(_SCRIPT, inputs, tmp_path)
    refs = {arch: _reference_side(ref, params, batch)
            for arch, (ref, params, _, batch) in models.items()}
    ones = {arch: _one_process(arch, state, batch)
            for arch, (_, _, state, batch) in models.items()}
    running.wait(DEADLINE)
    return running.out, refs, ones


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_the_reference_and_one_process(world, arch):
    got = torch.load(world[0] / f"{arch}-serve.pt", weights_only=True)
    for what in ("prefill", "at0", "at16"):
        close(got[what], world[1][arch][what], f"{what} against the reference")
        close(got[what], world[2][arch][what], f"{what} against one process")


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_splits_the_model_axis_and_prefill_takes_the_head_rule(world, arch):
    """Every rank holds each model-sharded leaf in part; the prefill's
    attention runs on the rank's heads, each decode step's on the gathered
    heads (the head-dim cache spec), as expected; the caches stay placed as
    ``cache_pspecs`` says."""
    n = n_attention(arch)
    for r, rep in enumerate(rank_reports(world[0], arch, "prefill")):
        assert rep["whole_here"] == [], (r, rep["whole_here"])
        assert rep["rules"] == ({"attention/local": n} if n else {}), (r, rep["rules"])
    for r, rep in enumerate(rank_reports(world[0], arch, "decode")):
        assert rep["rules"] == ({"attention/gathered": 2 * n} if n else {}), (r, rep["rules"])
        if n:
            entry = rep["cache_specs"][configs(arch)[1].block_kinds().index(
                next(k for k in configs(arch)[1].block_kinds() if k.startswith("attn")))]
            assert entry["k"] == "(Shard(dim=0), Shard(dim=0), Shard(dim=3))", entry


def test_the_dry_runs_decode_collectives_match_the_measured_world(world):
    """granite's decode step at position 16 on the 8-rank mesh, each
    collective as ``CommDebugMode`` counted it on rank 0, against
    ``dryrun.collectives``."""
    held_to_the_dry_run(world[0], "decode")


def test_the_head_rule_on_a_world_of_one(tmp_path):
    """q, k and v Shard(1) over ``model`` and Shard(0) over ``pod`` and
    ``data`` on a (1, 1, 1) mesh: one local call, its output on the same
    placements and equal to the call on whole tensors; q alone on its heads
    gathers."""
    out = run_world("""
        from torch.distributed.tensor import Shard, Replicate, distribute_tensor
        from repro_torch.kernels import ops
        from repro_torch.runtime import build_pod_mesh

        mesh = build_pod_mesh(1, 1, 1)
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(2, h, 8, 16, generator=g) for h in (4, 2, 2))
        heads = (Shard(0), Shard(0), Shard(1))
        dq, dk, dv = (distribute_tensor(t, mesh, heads) for t in (q, k, v))
        ops.dtensor_rules.clear()
        got = ops.attention(dq, dk, dv, causal=True)
        assert dict(ops.dtensor_rules) == {("attention", "local"): 1}, ops.dtensor_rules
        assert tuple(got.placements) == heads, got.placements
        assert torch.equal(got.full_tensor(), ops.attention(q, k, v, causal=True))
        ops.dtensor_rules.clear()
        rep = distribute_tensor(k, mesh, (Shard(0), Shard(0), Replicate()))
        ops.attention(dq, rep, rep, causal=True)
        assert dict(ops.dtensor_rules) == {("attention", "gathered"): 1}, ops.dtensor_rules
        print("head rule ok")
    """, 1, tmp_path)
    assert "head rule ok" in out[0]


def test_a_model_without_a_hook_gives_the_same_logits():
    """``Model(..., shard_activation=None)`` is the identity hook: the same
    logits, bit for bit, as a model built without the argument, and the
    reference's within the bound."""
    ref, params, state, batch = reference(COMM_ARCH)
    cfg = configs(COMM_ARCH)[1]
    plain = port_model(COMM_ARCH, state)
    hooked = Model(cfg, device="cpu", shard_activation=None)
    hooked.load_state_dict(state)
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        a, b = plain(tokens), hooked(tokens)
    assert torch.equal(a, b)
    close(a, np.asarray(jax.jit(ref.forward)(params, {"tokens": jnp.asarray(batch["tokens"])})),
          "forward")
