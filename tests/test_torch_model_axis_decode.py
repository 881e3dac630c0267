"""The model axis at run time: a prefill and decode steps on a (pod 2, data 2,
model 2) mesh of 8 gloo ranks, held to the reference and to the port's one
process; the measured world's collectives against the dry run's rules; the
head rule, the split rule and the hook on a world of one or in one process.

For granite-3-8b, mixtral-8x22b, jamba-1.5-large-398b and xlstm-350m (smoke,
f32; ``tests/torch_model_axis.py``) the ranks run ``prefill`` of the batch
(placed by ``batch_pspec``) into a cache of 32 positions, then, under each
of the two cache layouts of ``cache_pspecs`` (head_dim over ``model``, the
reference's default; the sequence over ``model``, ``cache_seq_shard``), a
decode step at position 0 on ``init_cache(8, 32)`` (the reference
docstring's step; rank model 1's half of a sequence-split cache holds no
valid slot) and one at position 16 on the prefill's cache. Read back whole,
every logit matches the reference's (one CPU device) and the port's
one-process run within 2e-4 + 2e-4·|ref|. Prefill attention takes the head
rule (``local``); a decode step on the head_dim cache takes the gathered
rule, which keeps the batch's shards and gathers K and V over ``model``
alone; on the sequence-split cache it takes the split rule (each rank its
own slots, two all-reduces), and a recurrent state of rank 4 (xlstm's mLSTM
``C``) is split on its heads, as the reference's ``cache_pspecs`` does.

Each arch's decode steps at position 16, and a prefill of the batch under
the production rules (no sequence sharding, a cache of its own length), run
under ``CommLog``: each collective's count and bytes, by operation and by
mesh dim, must be what ``launch/dryrun.py`` traces for rank 0 of the same
mesh, batch, sequence, cache layout and position on a ``"fake"`` process
group (the train steps': the train file); granite's sequence-split step
moves no cache shard, its head_dim one gathers K and V over ``model``
only.
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
    MESH,
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
    result = {"prefill": whole(prefill)}
    # The prefill the dry run traces: the production rules, its own length.
    model.shard = make_activation_sharder(serve_rules)
    with CommLog() as mode:
        model.prefill(placed, T)
    write_comm(mode, f"{arch}-prefill")
    model.shard = make_activation_sharder(rules)
    # Each layout's steps start from the prefill's cache as it came: a step
    # updates its cache in place (a recurrent state, the step's slot).
    caches = {"": cache, "-seq": [{k: t.clone() for k, t in e.items()} for e in cache]}
    for layout, with_rules in (("", rules), ("-seq", seq_rules)):
        ops.dtensor_rules.clear()
        fresh = place(model.init_cache(B, MAX_LEN), cache_pspecs, with_rules)
        at0, _ = model.decode_step(fresh, first, 0)
        placed_cache = place(caches[layout], cache_pspecs, with_rules)
        with CommLog() as mode:
            at16, _ = model.decode_step(placed_cache, last, T)
        write_comm(mode, f"{arch}-decode{layout}")
        report(arch, "decode" + layout,
               cache_specs=[{k: str(v.placements) for k, v in e.items()} for e in placed_cache])
        result.update({"at0" + layout: whole(at0), "at16" + layout: whole(at16)})
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
def test_decode_on_a_sequence_split_cache_matches_the_reference_and_one_process(world, arch):
    """The decode steps at 0 and 16 with every cache entry placed under
    ``cache_seq_shard``: the reference's and one process's logits within the
    bound."""
    got = torch.load(world[0] / f"{arch}-serve.pt", weights_only=True)
    for what in ("at0", "at16"):
        close(got[what + "-seq"], world[1][arch][what], f"{what}, sequence split, reference")
        close(got[what + "-seq"], world[2][arch][what], f"{what}, sequence split, one process")


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


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_a_sequence_split_cache_takes_the_split_rule(world, arch):
    """Every decode attention on the sequence-split cache takes the split
    rule, none the gathered one; a KV entry stays split on its sequence
    over ``model``; a rank-4 recurrent state (the mLSTM's C) on its heads."""
    kinds = configs(arch)[1].block_kinds()
    n = n_attention(arch)
    for r, rep in enumerate(rank_reports(world[0], arch, "decode-seq")):
        assert rep["rules"] == ({"attention/split": 2 * n} if n else {}), (r, rep["rules"])
        for kind, entry in zip(kinds, rep["cache_specs"], strict=True):
            if kind.startswith("attn"):
                assert entry["k"] == entry["v"] == "(Shard(dim=0), Shard(dim=0), Shard(dim=1))"
            if kind == "mlstm":
                assert entry["C"] == "(Shard(dim=0), Shard(dim=0), Shard(dim=1))", entry


def _held_decode_collectives(out, arch: str, cache_seq_shard: bool) -> None:
    """``arch``'s decode step at position 16, each collective as ``CommLog``
    recorded it on rank 0, against the dry run's per-rank trace for its
    cache layout; granite's collectives of a cache shard's operand: on the
    head_dim cache the gathers of K and V, two an attention layer, each
    over ``model`` alone; on the sequence-split cache none."""
    layout = "-seq" if cache_seq_shard else ""
    calls = held_to_the_dry_run(out, arch, "decode", "decode" + layout, cache_seq_shard)
    if arch != COMM_ARCH:
        return
    cfg = configs(COMM_ARCH)[1]
    shard = B // (MESH[0] * MESH[1]) * MAX_LEN * cfg.n_kv_heads * cfg.head_dim // MESH[2]
    of_cache = [c for c in calls if c[1] == shard]
    if cache_seq_shard:
        assert of_cache == [], of_cache
        assert sum(c[0] == "all_reduce" and c[3] == "model" for c in calls) >= 2 * cfg.n_layers
    else:
        assert len(of_cache) == 2 * n_attention(COMM_ARCH), calls
        assert all(c[0] == "all_gather_into_tensor" and c[3] == "model" for c in of_cache), calls


@pytest.mark.parametrize("arch", ARCHS)
def test_the_dry_runs_decode_collectives_match_the_measured_world(world, arch):
    """On the head_dim cache (the reference's default): counts and bytes as
    the dry run traces them; granite's K and V gathered over ``model``
    only."""
    _held_decode_collectives(world[0], arch, cache_seq_shard=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_dry_runs_decode_collectives_on_a_sequence_split_cache_match_the_measured_world(
        world, arch):
    """On the cache split on its sequence: counts and bytes as the dry run
    traces them; granite's split rule all-reduces over ``model``, no cache
    byte."""
    _held_decode_collectives(world[0], arch, cache_seq_shard=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_dry_runs_prefill_collectives_match_the_measured_world(world, arch):
    """A prefill under the production rules: counts and bytes, by operation
    and by mesh dim, as the dry run traces them."""
    assert held_to_the_dry_run(world[0], arch, "prefill")


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


def test_the_split_rule_on_a_world_of_one(tmp_path):
    """k and v split on their keys (Shard(2)) over ``model`` on a (1, 1, 1)
    mesh, q on its heads: one split call a ``kv_len``, its output laid out
    on the batch and replicated over ``model``, bit for bit the call on whole
    tensors (one rank: w = 1, a division by 1); with a window, the gathered
    rule."""
    out = run_world("""
        from torch.distributed.tensor import Shard, Replicate, distribute_tensor
        from repro_torch.kernels import ops
        from repro_torch.runtime import build_pod_mesh

        mesh = build_pod_mesh(1, 1, 1)
        g = torch.Generator().manual_seed(0)
        q = torch.randn(2, 4, 1, 16, generator=g)
        k, v = (torch.randn(2, 2, 40, 16, generator=g) for _ in range(2))
        dq = distribute_tensor(q, mesh, (Shard(0), Shard(0), Shard(1)))
        dk, dv = (distribute_tensor(t, mesh, (Shard(0), Shard(0), Shard(2))) for t in (k, v))
        for kv_len in (1, 17, 40):
            ops.dtensor_rules.clear()
            got = ops.attention(dq, dk, dv, kv_len=kv_len)
            assert dict(ops.dtensor_rules) == {("attention", "split"): 1}, ops.dtensor_rules
            assert tuple(got.placements) == (Shard(0), Shard(0), Replicate()), got.placements
            assert torch.equal(got.full_tensor(), ops.attention(q, k, v, kv_len=kv_len))
        ops.dtensor_rules.clear()
        ops.attention(dq, dk, dv, kv_len=17, window=8)
        assert dict(ops.dtensor_rules) == {("attention", "gathered"): 1}, ops.dtensor_rules
        print("split rule ok")
    """, 1, tmp_path)
    assert "split rule ok" in out[0]


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
