"""The port's dry run (``launch/{specs,mesh,dryrun}.py``), its counting mode
and the attention op's meta route, held to the reference's
``repro/launch/{specs,mesh,dryrun}.py`` where both have the same thing.

On the CPU, in process: the 40-cell accounting and each skip reason; every
arch's input shapes and dtypes against the reference's
``ShapeDtypeStruct``s; the production meshes; ``inner_scan_correction`` and
``model_flops``; the window-sized ring cache of mixtral's ``long_500k``;
each runnable cell's argument bytes on both meshes against the local shard
bytes of the reference's own specs over ``jax.eval_shape`` trees; a smoke
model's traced FLOPs against a hand count; each recurrent mixer's
T-extrapolated cost against a trace at that T; the meta route's shape,
entries, cost and that it builds and launches nothing; one cell through
``main`` rendered by the port's and the reference's ``roofline_table.rows``
alike; and exit 2 without a card unless ``--device cpu``.
"""

from __future__ import annotations

import functools
import importlib
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import benchmarks.roofline_table as ref_roofline
from repro.configs import get_config as ref_get_config
from repro.core import metrics as ref_metrics
from repro.launch import specs as ref_specs
from repro.models import Model as RefModel
from repro.optim import AdamW as RefAdamW
from repro.runtime import sharding as ref_sharding
from repro_torch.benchmarks import common, roofline_table
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core import metrics
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, mesh, specs
from repro_torch.models import Model


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` for 512 host
    devices: the variable is put back as it was for later subprocesses."""
    old = os.environ.get("XLA_FLAGS")
    module = importlib.import_module("repro.launch.dryrun")
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return module


class _FakeMesh:
    """Shape-only stand-in for the reference's rules."""

    def __init__(self, shape: dict):
        self.shape = shape


def _cells():
    return [(a, s) for a in ARCHS for s in specs.SHAPES]


# -- specs and meshes ------------------------------------------------------------


def test_forty_cells_and_each_skip_reason_equal_the_references():
    runnable = 0
    for arch, shape in _cells():
        got = specs.applicability(get_config(arch), shape)
        assert got == ref_specs.applicability(ref_get_config(arch), shape), (arch, shape)
        runnable += got[0]
    assert len(_cells()) == 40 and runnable == 32
    assert {n: (s.seq, s.batch, s.kind) for n, s in specs.SHAPES.items()} == {
        n: (s.seq, s.batch, s.kind) for n, s in ref_specs.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_references_shape_dtype_structs(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for shape in specs.SHAPES:
        got, want = specs.input_specs(cfg, shape), ref_specs.input_specs(ref_cfg, shape)
        assert set(got) == set(want), (arch, shape)
        for k, t in got.items():
            assert t.is_meta and tuple(t.shape) == tuple(want[k].shape), (arch, shape, k)
            assert str(t.dtype).removeprefix("torch.") == str(jnp.dtype(want[k].dtype)), (
                arch, shape, k, t.dtype, want[k].dtype)


def test_production_meshes_and_data_axes_equal_the_references(monkeypatch):
    from repro.launch import mesh as ref_mesh

    made = []
    monkeypatch.setattr(ref_mesh.jax, "make_mesh", lambda shape, axes: made.append(
        (tuple(shape), tuple(axes))))
    for multi in (False, True):
        ref_mesh.make_production_mesh(multi_pod=multi)
        got = mesh.make_production_mesh(multi_pod=multi)
        assert (tuple(got.values()), tuple(got)) == made[-1]
        assert mesh.data_axes(multi) == ref_mesh.data_axes(multi)
    assert (mesh.POD_SHAPE, mesh.MULTI_POD_SHAPE) == (ref_mesh.POD_SHAPE, ref_mesh.MULTI_POD_SHAPE)


def test_inner_scan_correction_and_model_flops_equal_the_references(ref_dryrun):
    for arch, shape in _cells():
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        s = specs.SHAPES[shape]
        for kind in ("train", "prefill", "decode"):
            for chips in (256, 512):
                assert dryrun.inner_scan_correction(cfg, s.batch, s.seq, kind, chips) == \
                    ref_dryrun.inner_scan_correction(ref_cfg, s.batch, s.seq, kind, chips)
                # The part the trace does not count is never more than the whole.
                part = dryrun.untraced_scan_flops(cfg, s.batch, s.seq, kind, chips)
                assert 0 <= part <= dryrun.inner_scan_correction(cfg, s.batch, s.seq, kind,
                                                                 chips)
        counts = cfg.param_counts()
        assert counts == ref_cfg.param_counts()
        tokens = s.batch * s.seq
        assert metrics.model_flops(counts["total"], tokens, active_params=counts["active"]) == \
            ref_metrics.model_flops(counts["total"], tokens, active_params=counts["active"])


def test_mixtral_long_500k_cache_is_window_sized_on_meta():
    import dataclasses

    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=1)  # one layer suffices
    cache = Model(cfg, device="meta").init_cache(1, 524288)
    assert cache[0]["k"].is_meta and cache[0]["k"].shape == (1, cfg.window, cfg.n_kv_heads,
                                                              cfg.head_dim)


# -- argument bytes against the reference's specs -----------------------------


def _ref_local_bytes(tree, spec_tree, sizes) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        shape = list(leaf.shape)
        for i, e in enumerate(tuple(spec)):
            names = () if e is None else (e if isinstance(e, tuple) else (e,))
            div = math.prod(sizes[a] for a in names)
            assert shape[i] % div == 0
            shape[i] //= div
        total += math.prod(shape) * jnp.dtype(leaf.dtype).itemsize
    return total


@functools.lru_cache(maxsize=None)
def _ref_trees(arch: str):
    cfg = ref_get_config(arch)
    model = RefModel(cfg, remat=False)
    return cfg, model, jax.eval_shape(model.init, jax.random.key(0))


def _ref_argument_bytes(arch: str, shape: str, multi: bool) -> dict:
    cfg, model, params = _ref_trees(arch)
    sizes = dict(pod=2, data=16, model=16) if multi else dict(data=16, model=16)
    rules = ref_sharding.ShardingRules(mesh=_FakeMesh(sizes),
                                       data_axes=("pod", "data") if multi else ("data",))
    p_specs = ref_sharding.param_pspecs(params, rules)
    s = ref_specs.SHAPES[shape]
    batch = ref_specs.input_specs(cfg, shape)
    out = {"params": _ref_local_bytes(params, p_specs, sizes)}
    if s.kind == "decode":
        out["batch"] = sum(math.prod(b.shape) * jnp.dtype(b.dtype).itemsize
                           for b in batch.values())
        cache = jax.eval_shape(lambda: model.init_cache(s.batch, s.seq))
        out["cache"] = _ref_local_bytes(cache, ref_sharding.cache_pspecs(cache, rules), sizes)
    else:
        out["batch"] = _ref_local_bytes(batch, ref_sharding.batch_pspec(batch, rules), sizes)
    if s.kind == "train":
        moment = "bfloat16" if cfg.param_counts()["total"] > 30e9 else "float32"
        opt = jax.eval_shape(RefAdamW(moment_dtype=moment).init, params)
        out["opt_state"] = (_ref_local_bytes(opt.m, p_specs, sizes)
                            + _ref_local_bytes(opt.v, p_specs, sizes) + 4)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_references_local_shards_on_both_meshes(arch):
    for shape in specs.SHAPES:
        if not specs.applicability(get_config(arch), shape)[0]:
            continue
        for multi in (False, True):
            meta = dryrun.build_cell(arch, shape, multi).meta
            assert meta["argument_bytes"] == _ref_argument_bytes(arch, shape, multi), (
                arch, shape, multi)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_moment_bytes_follow_the_references_rule_on_a_layers_own_dims(arch):
    """Under --zero the moments shard over the data axes too. Where the
    reference's ``zero_pspecs`` puts the data axes on the period axis of a
    stacked leaf, a port leaf (one layer, no period axis) takes the rule on
    its own dims (tests/test_torch_sharding.py); elsewhere the bytes are
    the reference's."""
    cfg, _, params = _ref_trees(arch)
    sizes = dict(data=16, model=16)
    rules = ref_sharding.ShardingRules(mesh=_FakeMesh(sizes), data_axes=("data",))
    p_specs = ref_sharding.param_pspecs(params, rules)
    z_specs = ref_sharding.zero_pspecs(p_specs, params, rules)
    moment = "bfloat16" if cfg.param_counts()["total"] > 30e9 else "float32"
    m = jax.eval_shape(RefAdamW(moment_dtype=moment).init, params).m
    is_spec = lambda x: isinstance(x, P)  # noqa: E731
    want = 0
    for (path, leaf), ps, zs in zip(jax.tree_util.tree_flatten_with_path(m)[0],
                                    jax.tree.leaves(p_specs, is_leaf=is_spec),
                                    jax.tree.leaves(z_specs, is_leaf=is_spec)):
        if any(getattr(k, "key", None) == "blocks" for k in path):
            layer = jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)
            spec = P(*tuple(zs)[1:]) if tuple(zs)[0] is None else ref_sharding.zero_pspecs(
                {"x": P(*tuple(ps)[1:])}, {"x": layer}, rules)["x"]
            want += leaf.shape[0] * _ref_local_bytes(layer, spec, sizes)
        else:
            want += _ref_local_bytes(leaf, zs, sizes)
    meta = dryrun.build_cell(arch, "train_4k", False, zero=True).meta
    assert meta["argument_bytes"]["opt_state"] == 2 * want + 4
    base = dryrun.build_cell(arch, "train_4k", False).meta["argument_bytes"]
    assert meta["argument_bytes"]["opt_state"] < base["opt_state"]


# -- the trace ---------------------------------------------------------------------


def test_a_dense_smoke_models_traced_flops_equal_a_hand_count():
    cfg = get_smoke_config("granite-3-8b")
    b, t = 2, 16
    shape = specs.ShapeSpec("smoke_prefill", t, b, "prefill")
    rec = dryrun.cell_record(dryrun.build_cell("granite-3-8b", shape, mesh={"data": 1, "model": 1},
                                               config=cfg), device="cpu")
    d, hd, hq, hkv, ff = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    n = b * t
    per_layer = 2 * n * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff)
    attention = 4 * hd * b * hq * (t * (t + 1) // 2)
    unembed = 2 * n * d * cfg.vocab  # in f32
    assert rec["flops_by_dtype"] == {"bfloat16": cfg.n_layers * (per_layer + attention),
                                     "float32": unembed}
    assert rec["cost"]["flops"] == cfg.n_layers * (per_layer + attention) + unembed
    assert rec["kernel_entries"] == {"flash_attention_bf16_simt": cfg.n_layers}  # 32 rows
    assert rec["temp_bound"] is None and rec["collectives"] == {}
    assert rec["memory"]["argument_size_in_bytes"] == sum(
        p.nbytes for p in Model(cfg, device="meta").parameters()) + n * 4
    r = rec["roofline"]
    hw = metrics.H100_SXM
    assert r["compute_s"] == pytest.approx(
        cfg.n_layers * (per_layer + attention) / hw.peak_bf16_flops + unembed / hw.peak_f32_flops)
    assert r["memory_s"] == pytest.approx(rec["cost"]["bytes accessed"] / hw.hbm_bw)
    assert rec["peaks"] == f"{hw.name} (data sheet; --device cpu)"


def _mixer_params(arch: str, kind: str, **replace):
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config(arch), **replace)
    model = Model(cfg, device="meta")
    block = next(b for b in model.blocks if b.kind.startswith(kind))
    params = dict(block.mixer.items()) if kind == "mamba" else block.params()
    return cfg, params


@pytest.mark.parametrize("arch,kind,name,replace,grad,t", [
    ("jamba-1.5-large-398b", "mamba", "apply_mamba", {}, False, 104),  # prefill's path
    ("jamba-1.5-large-398b", "mamba", "apply_mamba", {}, True, 104),
    ("xlstm-350m", "mlstm", "apply_mlstm", {}, True, 104),
    ("xlstm-350m", "mlstm", "apply_mlstm", {"xlstm_chunk": 8}, True, 72),  # chunked
    ("xlstm-350m", "slstm", "apply_slstm", {}, True, 104),
])
def test_each_mixers_extrapolated_cost_equals_a_trace_at_that_length(arch, kind, name,
                                                                      replace, grad, t):
    """The training path's plan holds the forward's counts too; t lies past
    the short lengths (and is a multiple of the chunk, on its path). The
    plan is the scan's, on the operands the mixer hands ``on_rows``."""
    cfg, params = _mixer_params(arch, kind, **replace)
    plan = dryrun.mixer_plan(name, params, cfg, 2, t, grad)
    direct, outs, spec = dryrun._mixer_cost(name, params, cfg, 2, t, grad)
    assert plan.outputs == outs and plan.spec == spec
    got, want = plan.cost, direct
    for field in ("nbytes", "peak", "saved", "bwd_nbytes", "bwd_peak"):
        assert getattr(got, field) == pytest.approx(getattr(want, field), rel=1e-12), field
    for field in ("flops", "bwd_flops"):
        g, w = getattr(got, field), getattr(want, field)
        assert set(k for k, v in g.items() if v) == set(w), field
        for k, v in w.items():
            assert g[k] == pytest.approx(v, rel=1e-12), (field, k)
    assert direct.flops and bool(direct.bwd_flops) == grad
    if replace:
        assert dryrun._short_lengths(cfg, name, t, 2) == (16, 32, 48, 64)  # chunks


def test_a_recurrent_cells_stand_ins_carry_the_planned_cost(monkeypatch):
    """A hybrid smoke model's training step: the Mamba scan's stand-in under
    remat (its forward twice, its saved bytes held for the backward),
    attention through the meta route (forward and remat recomputation). A
    stand-in takes a scan past 96 tokens (below, the scan itself is
    traced): 128 here."""
    cfg = get_smoke_config("jamba-1.5-large-398b")
    shape = specs.ShapeSpec("smoke_train", 128, 2, "train")
    cell = dryrun.build_cell(cfg.name, shape, mesh={"data": 1, "model": 1}, config=cfg)
    plans, plan_fn = [], dryrun.mixer_plan
    monkeypatch.setattr(dryrun, "mixer_plan", lambda *a: plans.append(plan_fn(*a)) or plans[-1])
    rec = dryrun.cell_record(cell, device="cpu")
    (plan,) = plans
    kinds = cfg.block_kinds()
    assert sum(rec["kernel_entries"].values()) == 2 * sum(k.startswith("attn") for k in kinds)
    # At least the stand-ins' FLOPs: two forwards and a backward a Mamba layer.
    stand_in = sum(k.startswith("mamba") for k in kinds) * (
        2 * sum(plan.cost.flops.values()) + sum(plan.cost.bwd_flops.values()))
    assert rec["cost"]["flops"] > stand_in > 0 and rec["memory"]["temp_size_in_bytes"] > 0
    assert plan.cost.saved > 0 and plan.grad
    assert rec["inner_scan_correction_flops"] == dryrun.untraced_scan_flops(
        cfg, 2, 128, "train", 1)
    # The stand-ins are back out after the trace.
    from repro_torch.models import layers, ssm
    assert ssm.apply_mamba.__module__ == "repro_torch.models.ssm"
    assert ssm.on_rows is layers.on_rows


def _param_bytes(meta_model_params, specs_, sizes) -> dict:
    by_dtype = {}
    for k, t in meta_model_params.items():
        n = math.prod(dryrun._local_shape(tuple(t.shape), specs_[k], sizes)) * t.element_size()
        by_dtype[t.dtype] = by_dtype.get(t.dtype, 0) + n
    return by_dtype


@pytest.mark.parametrize("knob", ["no model axis", "dp_only", "zero", "zero3"])
def test_collectives_follow_the_stated_rules(knob):
    """A train step that does not run on DTensors keeps the stated rules:
    without a model axis, or with both axes data parallel, one all-reduce a
    dtype of one flat buffer (the f32 one with the loss); under ZeRO one
    reduce-scatter a dtype and one all-gather (three under ZeRO-3: forward,
    remat recomputation, backward). The data axis of 16 over granite-3-8b's
    bf16 leaves."""
    from repro_torch.runtime.sharding import ShardingRules, param_pspecs, zero_pspecs

    arch = "granite-3-8b"
    kw = {"no model axis": dict(mesh={"data": 16, "model": 1}), "dp_only": dict(dp_only=True),
          "zero": dict(zero=True), "zero3": dict(zero3=True)}[knob]
    meta = dryrun.build_cell(arch, "train_4k", False, **kw).meta
    params = dict(Model(get_config(arch), device="meta").named_parameters())
    sizes = {"data": 16, "model": 1} if knob == "no model axis" else {"data": 16, "model": 16}
    axes = ("data", "model") if knob == "dp_only" else ("data",)
    rules = ShardingRules(mesh=sizes, data_axes=axes,
                          replicate_below=1 << 62 if knob == "dp_only" else 0)
    p_specs = param_pspecs(params, rules)
    if knob == "zero3":
        p_specs = zero_pspecs(p_specs, params, rules)
    by_dtype = _param_bytes(params, p_specs, sizes)
    assert set(by_dtype) == {torch.bfloat16}
    n = by_dtype[torch.bfloat16]
    if knob.startswith("zero"):
        gathers = 3 if knob == "zero3" else 1
        want = {"reduce-scatter": {"count": 1.0, "bytes": float(n)},
                "all-gather": {"count": float(gathers), "bytes": float(gathers * n)}}
        assert meta["temp_bound"].startswith(f"--{knob}:")
    else:
        want = {"all-reduce": {"count": 2.0, "bytes": 2.0 * (n + 4)}}
        assert meta["temp_bound"] is None
    assert meta["collectives"] == want and meta["analysis"] == "meta-trace"


@pytest.mark.parametrize("cache_seq_shard", (False, True))
def test_a_decode_cells_collective_bytes_follow_its_cache_layout(cache_seq_shard):
    """granite-3-8b's decode_32k on the production pod (data 16, model 16:
    8 rows a device, a cache of 32768), traced as rank 0: a cache split on
    head_dim gathers K and V whole over the model axis, one each an
    attention layer (the cache's order: 8 x 32768 x 8 x 128 bf16 each);
    split on its sequence, no collective moves a cache's bytes and the
    split rule's two all-reduces a layer go over the model axis; the
    record's histograms are the trace's calls."""
    cfg = get_config("granite-3-8b")
    cell = dryrun.build_cell("granite-3-8b", "decode_32k", False,
                             cache_seq_shard=cache_seq_shard)
    trace, _ = cell.trace()
    n, b, s = cfg.n_layers, 8, 32768
    kv = b * s * cfg.n_kv_heads * cfg.head_dim * 2  # one layer's K (or V), whole D
    of_cache = [c for c in trace.calls if c[1] >= kv]
    if cache_seq_shard:
        assert of_cache == []
        merges = [c for c in trace.calls if c[0] == "all-reduce" and c[2] == "model"]
        assert len(merges) >= 2 * n
    else:
        assert of_cache == [["all-gather", kv, "model"]] * (2 * n)
    assert cell.meta["collectives"] == trace.collectives()
    assert sum(h["count"] for h in cell.meta["collectives"].values()) == len(trace.calls)
    assert cell.meta["cache_seq_shard"] is cache_seq_shard


# -- the meta route ----------------------------------------------------------------


class _Counter:
    def __init__(self):
        self.calls = []

    def kernel(self, entry, flops, nbytes, dtype):
        self.calls.append((entry, flops, nbytes, dtype))


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


@pytest.mark.parametrize("hq,hkv,t,s,d,dtype,causal,entry", [
    (48, 8, 256, 256, 128, torch.bfloat16, True, "flash_attention_bf16_wgmma"),  # group 6
    (64, 8, 256, 256, 128, torch.bfloat16, True, "flash_attention_bf16_wgmma"),  # group 8
    (16, 16, 512, 512, 80, torch.bfloat16, False, "flash_attention_bf16_wgmma"),  # D 80
    (32, 8, 1, 1096, 128, torch.bfloat16, False, "flash_decode_bf16"),
    (4, 2, 16, 16, 16, torch.float32, True, "flash_attention_f32"),
])
def test_the_meta_route_returns_the_kernels_shape_names_its_entry_and_builds_nothing(
        monkeypatch, hq, hkv, t, s, d, dtype, causal, entry):
    def refuse(*a, **k):
        raise AssertionError("the meta route built or bound a kernel")

    monkeypatch.setattr(_build, "function", refuse)
    monkeypatch.setattr(_build, "library", refuse, raising=False)
    launches, plain = dict(fa.launches), fa.plain_calls
    b = 2
    q, k, v = _meta(b, hq, t, d, dtype=dtype), _meta(b, hkv, s, d, dtype=dtype), \
        _meta(b, hkv, s, d, dtype=dtype)
    counter = _Counter()
    with fa.counting_meta(counter), ops.force_impl("kernel"):
        out = ops.attention(q, k, v, causal=causal)
    assert out.is_meta and out.shape == (b, hq, t, d) and out.dtype == dtype
    assert out.transpose(1, 2).is_contiguous()  # (B, T, Hq, D) in memory, as the card's
    pairs = fa.visible_pairs(t, s, causal, None)
    assert counter.calls == [(entry, 4.0 * d * b * hq * pairs,
                              float((2 * q.numel() + k.numel() + v.numel()) * q.element_size()),
                              dtype)]
    assert fa.launches == launches and fa.plain_calls == plain
    # Without force_impl a meta tensor is not a CUDA one: the plain route.
    assert fa._route(q, k, v) == entry


def test_visible_pairs_closed_form_equals_the_loop():
    def loop(t, s, causal, window):
        total = 0
        for i in range(t):
            q = s - t + i
            hi = min(q + 1, s) if causal else s
            lo = max(q - window + 1, 0) if window is not None else 0
            total += max(hi - lo, 0)
        return total

    for t, s in ((1, 1), (1, 1088), (16, 16), (40, 100), (64, 7)):
        for causal in (False, True):
            for window in (None, 1, 5, 4096):
                assert fa.visible_pairs(t, s, causal, window) == loop(t, s, causal, window)


def test_the_meta_backward_is_attention_bwd_torch_traced_once_a_shape():
    q, k, v = _meta(2, 8, 64, 64, grad=True), _meta(2, 2, 64, 64, grad=True), \
        _meta(2, 2, 64, 64, grad=True)
    trace = dryrun.Trace()
    calls = fa.backward_calls["attention_bwd_torch"]
    with ops.force_impl("kernel"), fa.counting_meta(trace), trace:
        o1 = ops.attention(q, k, v, causal=True)
        o2 = ops.attention(q, k, v, causal=True)
        d1, d2 = torch.empty_like(o1), torch.empty_like(o2)
        counts = [(dict(trace.flops), trace.bytes)]
        g1 = torch.autograd.grad(o1, [q, k, v], grad_outputs=d1)
        counts.append((dict(trace.flops), trace.bytes))
        g2 = torch.autograd.grad(o2, [q, k, v], grad_outputs=d2)
        counts.append((dict(trace.flops), trace.bytes))
    assert [g.shape for g in g1] == [g.shape for g in g2] == [q.shape, k.shape, v.shape]
    assert trace.replays == 1 and fa.backward_calls["attention_bwd_torch"] == calls + 2
    assert trace.entries == {"flash_attention_bf16_wgmma": 2}
    # The replay added what the traced call added.
    (f0, b0), (f1, b1), (f2, b2) = counts
    assert b2 - b1 == b1 - b0 > 0
    assert {k: f2[k] - f1.get(k, 0) for k in f2} == {k: f1[k] - f0.get(k, 0) for k in f1}
    assert f1["float32"] - f0.get("float32", 0) > 0


def test_a_cpu_tensor_keeps_its_plain_route():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(np.float32))
               for _ in range(3))
    plain = fa.plain_calls
    counter = _Counter()
    with fa.counting_meta(counter), ops.force_impl("kernel"):
        out = ops.attention(q, k, v, causal=True)
    assert fa.plain_calls == plain + 1 and counter.calls == []
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v, causal=True))


# -- the CLI and the roofline rows ----------------------------------------------------


def test_a_cell_through_main_renders_as_the_references_rows(tmp_path, monkeypatch):
    out = str(tmp_path)
    for arch, shape in (("qwen1.5-0.5b", "decode_32k"), ("hubert-xlarge", "decode_32k")):
        assert dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single",
                            "--device", "cpu", "--out", out]) == 0
    files = sorted(os.listdir(out))
    assert files == ["hubert-xlarge__decode_32k__single__baseline.json",
                     "qwen1.5-0.5b__decode_32k__single__baseline.json"]
    with open(os.path.join(out, files[1])) as f:
        rec = json.load(f)
    assert rec["kernel_entries"] == {"flash_decode_bf16": 24} and rec["device"] == "cpu"
    monkeypatch.setattr(roofline_table, "DRYRUN_DIR", out)
    monkeypatch.setattr(ref_roofline, "DRYRUN_DIR", out)
    got = roofline_table.rows("single")
    assert got == ref_roofline.rows("single") and len(got) == 2
    assert got[0][2].startswith("skip=encoder-only")
    assert roofline_table.rows("multi") == []
    # The roofline section renders them.
    from repro_torch.benchmarks import run

    lines = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: lines.append(" ".join(map(str, a))))
    assert run.main(["--device", "cpu", "--sections", "roofline"]) == 0
    assert [line.split(",")[0] for line in lines if line.startswith("roofline.")] == [
        n for n, _, _ in got]


def test_records_go_to_their_own_directory_not_the_references():
    assert os.path.normpath(common.DRYRUN_DIR) == os.path.normpath(dryrun.ARTIFACT_DIR)
    assert os.path.basename(os.path.normpath(common.DRYRUN_DIR)) == "dryrun_torch"
    assert os.path.normpath(common.DRYRUN_DIR) != os.path.normpath(ref_roofline.DRYRUN_DIR)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a CUDA card")
def test_without_a_card_the_cli_exits_2_unless_asked_for_the_cpu(tmp_path, capsys):
    args = ["--arch", "xlstm-350m", "--shape", "long_500k", "--mesh", "single",
            "--out", str(tmp_path)]
    assert dryrun.main(args) == 2
    assert os.listdir(tmp_path) == [] and "--device cpu" in capsys.readouterr().err
    assert dryrun.main(args + ["--device", "cpu"]) == 0
    assert os.listdir(tmp_path) == ["xlstm-350m__long_500k__single__baseline.json"]
