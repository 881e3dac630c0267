"""The port's sharding rules (``runtime/sharding.py``) and int8
error-feedback compression (``optim/compression.py``), held to the
reference's.

In process, by shape only: ``param_pspecs``, ``cache_pspecs``,
``batch_pspec`` and ``zero_pspecs`` against the reference's for all ten
architectures at full config on (data 16, model 16) and (pod 2, data 16,
model 16) sizes, leaf for leaf through ``convert``'s names (layer n·P + j
is the reference's period position j of period n, its leading period entry
dropped); the assertions of ``tests/test_runtime.py:28-88``;
``shard_applies`` against the reference's for every benchmark at preset 0;
the activation sharder's spec decision against the reference's, and the
dp-only binding never naming an axis twice (``tests/test_perf_knobs.py:
127``, which fails in the reference: the port is held to its docstring).
The mini mesh of ``tests/test_distributed.py:79`` (also failing in the
reference) is held to its docstring where the port runs it: specs valid at
(2, 2, 2), the smoke models' parameters and caches placed on a real
(data 2, model 2) mesh of 4 gloo ranks and read back whole, and the
activation sharder placing DTensor activations by its spec there (the
model axis runs: ``tests/test_torch_model_axis_*.py``).
``ErrorFeedbackInt8`` at 2 gloo ranks against the reference's
``shard_map`` over 2 forced host devices on the same numpy gradients.
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.core.registry import get_benchmark as ref_benchmark
from repro.models import Model as RefModel
from repro.runtime import sharding as ref_sharding
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.registry import all_benchmarks
from repro_torch.models import Model
from repro_torch.runtime.sharding import (
    ShardingRules,
    batch_pspec,
    cache_pspecs,
    make_activation_sharder,
    param_pspecs,
    shard_applies,
    zero_pspecs,
)
from torch_world import SRC, run_world


class _FakeMesh:
    """Shape-only stand-in for the reference's rules (tests/test_runtime.py)."""

    def __init__(self, shape: dict):
        self.shape = shape


SIZES = {
    "16x16": (dict(data=16, model=16), ("data",)),
    "2x16x16": (dict(pod=2, data=16, model=16), ("pod", "data")),
}
CACHE_BATCH, CACHE_LEN = 32, 128


def _norm(spec) -> tuple:
    """A spec as a tuple with one-name tuples as the name (the reference's
    PartitionSpec folds them)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _leaves(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}.")
        else:
            yield prefix + name, value


def _by_port_name(cfg, blocks, top=None) -> dict:
    """The reference's stacked tree of specs (or shapes), keyed by the port's
    leaf names: period position j of period n is layer n·P + j."""
    period = len(cfg.block_period())
    out = {}
    for j, tree in enumerate(blocks):
        for name, leaf in _leaves(tree):
            for n in range(cfg.n_periods):
                out[f"blocks.{n * period + j}.{name}"] = leaf
    for name, leaf in (top or {}).items():
        out[name] = leaf
    return out


@functools.lru_cache(maxsize=None)
def _reference_shapes(arch: str):
    cfg = ref_get_config(arch)
    model = RefModel(cfg, remat=False)
    params = jax.eval_shape(model.init, jax.random.key(0))
    cache = jax.eval_shape(lambda: model.init_cache(CACHE_BATCH, CACHE_LEN))
    return cfg, params, cache


def test_port_and_reference_list_the_same_architectures():
    assert tuple(ARCHS) == tuple(REF_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_functions_equal_the_reference_at_full_config(arch):
    ref_cfg, ref_params, ref_cache = _reference_shapes(arch)
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    state = model.state_dict()
    cache = model.init_cache(CACHE_BATCH, CACHE_LEN)
    top = {k: v for k, v in ref_params.items() if k != "blocks"}
    ref_shapes = _by_port_name(ref_cfg, ref_params["blocks"], top)
    assert set(ref_shapes) == set(state), arch
    for label, (sizes, data_axes) in SIZES.items():
        for cache_seq in (False, True):
            rules = ShardingRules(mesh=sizes, data_axes=data_axes, cache_seq_shard=cache_seq)
            ref_rules = ref_sharding.ShardingRules(mesh=_FakeMesh(sizes), data_axes=data_axes,
                                                   cache_seq_shard=cache_seq)
            # Parameters, and the ZeRO-1 moments' specs.
            specs = param_pspecs(state, rules)
            ref_specs = ref_sharding.param_pspecs(ref_params, ref_rules)
            want = _by_port_name(ref_cfg, ref_specs["blocks"],
                                 {k: v for k, v in ref_specs.items() if k != "blocks"})
            zero = zero_pspecs(specs, state, rules)
            ref_zero = ref_sharding.zero_pspecs(ref_specs, ref_params, ref_rules)
            ref_zero = _by_port_name(ref_cfg, ref_zero["blocks"],
                                     {k: v for k, v in ref_zero.items() if k != "blocks"})
            for name, t in state.items():
                stacked = name.startswith("blocks.")
                assert tuple(t.shape) == tuple(ref_shapes[name].shape)[int(stacked):], name
                assert _norm(specs[name]) == _norm(tuple(want[name])[int(stacked):]), (
                    arch, label, name, specs[name], want[name])
                zw = tuple(ref_zero[name])
                if stacked and zw[0] is not None:
                    # The reference put the data axes on the periods, an axis
                    # a port leaf has not: its rule on the layer's own dims.
                    one = ref_sharding.zero_pspecs(
                        {"x": P(*tuple(want[name])[1:])},
                        {"x": jax.ShapeDtypeStruct(tuple(t.shape), np.float32)}, ref_rules)
                    zw = tuple(one["x"])
                elif stacked:
                    zw = zw[1:]
                assert _norm(zero[name]) == _norm(zw), (arch, label, name, zero[name], zw)
            # Decode caches (only the attention caches under cache_seq_shard
            # differ).
            got = cache_pspecs(cache, rules)
            ref_c = ref_sharding.cache_pspecs(ref_cache, ref_rules)
            period = len(ref_cfg.block_period())
            assert len(got) == len(cache) == ref_cfg.n_periods * period
            for layer, entry in enumerate(got):
                ref_entry = ref_c[layer % period]
                assert set(entry) == set(ref_entry), (arch, layer)
                for k, spec in entry.items():
                    assert _norm(spec) == _norm(tuple(ref_entry[k])[1:]), (
                        arch, label, layer, k, spec, ref_entry[k])
        if label == "16x16":
            # tests/test_runtime.py: sharded dims divide, and over 95% of the
            # parameter bytes shard over the model axis.
            sharded = total = 0
            for name, t in state.items():
                n = math.prod(t.shape)
                total += n
                spec = specs[name]
                for i, axis in enumerate(spec):
                    if axis == "model":
                        assert t.shape[i] % 16 == 0, (name, t.shape, spec)
                if "model" in spec:
                    sharded += n
            assert sharded / total > 0.95, f"{arch}: only {sharded / total:.2%} sharded"


def test_moe_expert_rules_and_zero_extension():
    """tests/test_runtime.py:59-88: mixtral's 8 experts fall back to d_ff on
    a 16-way model axis, dbrx's 16 take expert parallelism, and ZeRO adds
    the data axis to some leaf."""
    rules = ShardingRules(mesh={"data": 16, "model": 16})
    for arch, want in (("mixtral-8x22b", (None, None, "model")),
                       ("dbrx-132b", ("model", None, None))):
        specs = param_pspecs(Model(get_config(arch), device="meta").state_dict(), rules)
        assert specs["blocks.0.ffn.w_gate"] == want, arch
    state = Model(get_smoke_config("granite-8b"), device="meta").state_dict()
    rules = ShardingRules(mesh={"data": 2, "model": 2})
    base = param_pspecs(state, rules)
    zero = zero_pspecs(base, state, rules)
    assert sum(sum(a is not None for a in zero[k]) > sum(a is not None for a in base[k])
               for k in state) > 0


@pytest.mark.parametrize("sizes", [dict(data=32), dict(data=3), dict(pod=2, data=4)])
def test_batch_pspec_equals_the_reference(sizes):
    axes = tuple(sizes)
    rules = ShardingRules(mesh={**sizes, "model": 1}, data_axes=axes)
    ref_rules = ref_sharding.ShardingRules(mesh=_FakeMesh({**sizes, "model": 1}), data_axes=axes)
    for b in (1, 24, 32, 48):
        batch = {"tokens": torch.empty(b, 16, device="meta"),
                 "embeds": torch.empty(b, 16, 8, device="meta"),
                 "positions": torch.empty(b, 16, 3, device="meta")}
        ref = ref_sharding.batch_pspec(
            {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32) for k, v in batch.items()},
            ref_rules)
        got = batch_pspec(batch, rules)
        assert {k: _norm(v) for k, v in got.items()} == {k: _norm(v) for k, v in ref.items()}


def test_shard_applies_equals_the_reference_for_every_benchmark():
    """By shape only, at preset 0 and 1, 2, 3, 4 and 8 devices."""
    checked = 0
    for spec in all_benchmarks():
        w, rw = spec.build_preset(0), ref_benchmark(spec.name).build_preset(0)
        args = w.make_inputs(0)
        for n in (1, 2, 3, 4, 8):
            assert shard_applies(args, w, n) == ref_sharding.shard_applies(args, rw, n), (
                spec.name, n)
        checked += 1
    assert checked == 36


@pytest.mark.parametrize("sizes,axes,seq,gather", [
    (dict(data=2, model=4), ("data",), False, False),
    (dict(data=2, model=4), ("data",), True, True),
    (dict(data=4, model=1), ("data", "model"), True, False),
    (dict(data=3, model=2), ("data", "model"), True, True),
])
def test_activation_sharder_spec_equals_the_reference(monkeypatch, sizes, axes, seq, gather):
    """The port's spec decision is the reference's (its constraint captured);
    with the model axis folded into data no spec names an axis twice."""
    captured = []
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: captured.append(s) or x)
    kw = dict(data_axes=axes, seq_shard=seq, moe_gather_tokens=gather)
    ref_shard = ref_sharding.make_activation_sharder(
        ref_sharding.ShardingRules(mesh=_FakeMesh(sizes), **kw))
    shard = make_activation_sharder(ShardingRules(mesh=sizes, **kw))
    for shape in ((8, 16, 32), (6, 12, 32), (8, 32), (5, 32), (8,)):
        for name in ("logits", "residual", "moe_in"):
            captured.clear()
            ref_shard(jax.ShapeDtypeStruct(shape, np.float32), name)
            want = _norm(captured[0]) if captured else None
            got = shard.spec(shape, name)
            assert (None if got is None else _norm(got)) == want, (shape, name, got, want)
            names = [a for e in (got or ()) for a in (e if isinstance(e, tuple) else (e,))
                     if a is not None]
            assert len(names) == len(set(names)), (shape, name, got)


def test_activation_sharder_is_the_identity_unless_tensor_parallel():
    """A plain tensor passes through while the model axis has size 1 (or is
    folded into the data axes); at a model axis of more it has no mesh to be
    placed on, and the hook says so."""
    x = torch.ones(2, 4, 8)
    for sizes, axes in ((dict(data=4, model=1), ("data",)),
                        (dict(data=2, model=2), ("data", "model"))):
        shard = make_activation_sharder(ShardingRules(mesh=sizes, data_axes=axes))
        assert shard(x, "residual") is x
    tp = make_activation_sharder(ShardingRules(mesh=dict(data=2, model=2)))
    with pytest.raises(ValueError, match="no mesh to place it on"):
        tp(x, "logits")


def test_activation_sharder_redistributes_a_dtensor_to_its_spec(tmp_path):
    """In a 4-rank (data 2, model 2) world, with seq_shard: each activation
    lands on ``placements(spec(shape, name))`` with its values unchanged, and
    one whose spec is None (``moe_in`` without ``moe_gather_tokens``) is
    returned as it is."""
    out = run_world("""
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.runtime.elastic import build_mesh
        from repro_torch.runtime.sharding import (ShardingRules, make_activation_sharder,
                                                  placements)

        mesh = build_mesh(None, 2, 2)
        shard = make_activation_sharder(ShardingRules(mesh=mesh, seq_shard=True))
        whole = torch.arange(8 * 16 * 6, dtype=torch.float32).reshape(8, 16, 6)
        x = distribute_tensor(whole, mesh, (Replicate(), Replicate()))
        want = {"embed": (Shard(0), Shard(1)), "residual": (Shard(0), Shard(1)),
                "logits": (Shard(0), Shard(2))}
        for name, pl in want.items():
            y = shard(x, name)
            assert tuple(y.placements) == pl == placements(shard.spec(tuple(x.shape), name), mesh)
            assert torch.equal(y.full_tensor(), whole), name
        assert shard.spec(tuple(x.shape), "moe_in") is None and shard(x, "moe_in") is x
        step = distribute_tensor(whole[:, 0], mesh, (Replicate(), Replicate()))
        assert tuple(shard(step, "logits").placements) == (Shard(0), Shard(1))
        print("sharder ok")
    """, 4, tmp_path)
    assert "sharder ok" in out[0]


def test_production_specs_on_the_mini_mesh_and_real_placement(tmp_path):
    """The (2, 2, 2) mini mesh's specs are valid for the four smoke models
    (every sharded dim divides its axes), and the smoke models' parameters
    and caches placed on a real (data 2, model 2) mesh of 4 ranks by their
    specs read back whole."""
    sizes = dict(pod=2, data=2, model=2)
    rules = ShardingRules(mesh=sizes, data_axes=("pod", "data"), seq_shard=True)
    archs = ("granite-3-8b", "mixtral-8x22b", "jamba-1.5-large-398b", "xlstm-350m")
    for arch in archs:
        model = Model(get_smoke_config(arch), device="meta")
        trees = [(model.state_dict(), param_pspecs(model.state_dict(), rules))]
        cache = model.init_cache(8, 32)
        trees += list(zip(cache, cache_pspecs(cache, rules)))
        for leaves, specs in trees:
            for name, t in leaves.items():
                for d, entry in enumerate(specs[name]):
                    axes = entry if isinstance(entry, tuple) else (entry,)
                    n = math.prod(sizes[a] for a in axes if a is not None)
                    assert t.shape[d] % n == 0, (arch, name, specs[name], t.shape)
    out = run_world("""
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import Model
        from repro_torch.runtime.elastic import build_mesh
        from repro_torch.runtime.sharding import (ShardingRules, cache_pspecs, host_data_mesh,
                                                  param_pspecs, placements)

        hosts = host_data_mesh(2)
        assert hosts.mesh_dim_names == ("host", "data") and tuple(hosts.shape) == (2, 2)
        assert list(hosts.get_coordinate()) == list(divmod(RANK, 2))
        mesh = build_mesh(None, 2, 2)
        rules = ShardingRules(mesh=mesh)
        placed = 0
        for arch in %r:
            model = Model(get_smoke_config(arch), device="cpu")
            model.init_weights(torch.Generator().manual_seed(0))
            state = model.state_dict()
            trees = [(state, param_pspecs(state, rules))]
            cache = [{k: torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
                      for k, v in e.items()} for e in model.init_cache(8, 32)]
            trees += list(zip(cache, cache_pspecs(cache, rules)))
            for leaves, specs in trees:
                for name, t in leaves.items():
                    d = distribute_tensor(t, mesh, placements(specs[name], mesh))
                    assert torch.equal(d.full_tensor(), t), (arch, name)
                    placed += d.to_local().numel() < t.numel()
        print("sharded leaves", placed)
    """ % (archs,), 4, tmp_path)
    assert int(out[0].split()[-1]) > 0


def test_error_feedback_int8_equals_the_reference_at_two_ranks(tmp_path):
    """Over 16 error-feedback steps each element of the reduced gradients
    within 2 f32 ulps of the reference's largest |value| (the bound fixed
    before the first run; observed 0: a quantization step flipped by a
    rounding difference would exceed it), and of the error state within 2
    ulps of the largest |g + e| (the first run broke the first bound, 2 ulps
    of the largest |e|: the error is ``g + e - q*scale``, a cancellation
    rounded at the scale of ``g + e``, which XLA contracts into one fused
    multiply-add where torch rounds the product first). The reference's
    own conditions hold too: one shot within 8% of the exact mean, and
    error feedback halving it over 16 steps."""
    g = np.random.default_rng(2).standard_normal((2, 256)).astype(np.float32)
    np.save(tmp_path / "g.npy", g)
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent("""
        import sys, numpy as np, jax, jax.numpy as jnp
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.optim.compression import ErrorFeedbackInt8
        from repro.runtime.sharding import shard_map
        mesh = Mesh(np.asarray(jax.devices()[:2]), ("pod",))
        comp = ErrorFeedbackInt8(axis="pod")
        def f(gsh, esh):
            out, err = comp.reduce_mean({"w": gsh}, {"w": esh})
            return out["w"], err["w"]
        fm = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("pod"), P("pod")),
                               out_specs=(P(), P("pod")), check_vma=False))
        g = jnp.asarray(np.load(sys.argv[1] + "/g.npy"))
        e = jnp.zeros((2, 256)); reds, errs = [], []
        for i in range(16):
            red, e = fm(g, e)
            reds.append(np.asarray(red).reshape(-1, 256)[0]); errs.append(np.asarray(e))
        np.savez(sys.argv[1] + "/ref.npz", reds=np.stack(reds), errs=np.stack(errs))
    """), str(tmp_path)], env=dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                                   XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    run_world("""
        import numpy as np
        from repro_torch.optim import ErrorFeedbackInt8

        comp = ErrorFeedbackInt8()
        g = torch.from_numpy(np.load(os.path.join(%r, "g.npy"))[RANK:RANK + 1])
        e = comp.init({"w": g})
        reds, errs = [], []
        for i in range(16):
            red, e = comp.reduce_mean({"w": g}, e)
            reds.append(red["w"][0].numpy())
            parts = [torch.empty_like(e["w"]) for _ in range(WORLD)]
            dist.all_gather(parts, e["w"])
            errs.append(torch.cat(parts).numpy())
        if RANK == 0:
            np.savez(os.path.join(%r, "port.npz"), reds=np.stack(reds), errs=np.stack(errs))
    """ % (str(tmp_path), str(tmp_path)), 2, tmp_path)
    _, err = ref.communicate(timeout=120)
    assert ref.returncode == 0, err
    want, got = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    observed = {}
    scales = {"reds": np.abs(want["reds"]).max(),
              "errs": (np.abs(g)[None] + np.abs(want["errs"])).max()}
    for key, scale in scales.items():
        bound = 2 * np.finfo(np.float32).eps * scale
        observed[key] = float(np.abs(got[key] - want[key]).max())
        assert observed[key] <= bound, (key, observed[key], bound)
    exact = g.mean(0)
    rel = np.abs(got["reds"][0] - exact).max() / np.abs(exact).max()
    rel2 = np.abs(got["reds"].mean(0) - exact).max() / np.abs(exact).max()
    assert rel < 0.08 and rel2 < rel / 2, (rel, rel2)
    print("observed max |port - reference|:", json.dumps(observed), "rel", rel, "rel2", rel2)
