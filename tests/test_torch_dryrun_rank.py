"""The dry run's per-rank trace (``launch/dryrun.py``, ``launch/mesh.py::
mesh_rank``): a cell on a model axis traced as rank 0 of its mesh on
DTensors over a ``"fake"`` process group, on the CPU, in process.

One sharded product counted at the rank's own FLOPs while sharding
propagation's global-shape operations go uncounted; attention's meta route
handed the rank's own rows and heads; a smoke cell traced on
a world of one against one device's trace (FLOPs and argument bytes equal,
the peak within the band phase 4o holds the card to); production cells
whose shards sum to the specs' argument bytes, and a misplaced leaf that
fails the cell; each smoke train step's per-rank temp at most its
undivided one; the fake group gone after a trace, a present one refused;
and a failing per-rank trace that makes the CLI exit 1. The collectives
are held to measured gloo worlds in ``tests/test_torch_model_axis_
{train,decode}.py``.
"""

from __future__ import annotations

import dataclasses
import os

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.launch import dryrun, mesh, specs
from repro_torch.runtime import sharding

# The band within which phase 4o holds a predicted peak to the measured one
# (chip_smoke.py DRYRUN_PEAK_BAND): a world of one's trace against one
# device's, whose DTensor layer adds its own copies.
PEAK_BAND = (0.8, 1.25)
SMOKE = {"pod": 2, "data": 2, "model": 2}


def _smoke(arch: str):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _shape(kind: str) -> specs.ShapeSpec:
    return specs.ShapeSpec(f"smoke_{kind}", 32 if kind == "decode" else 16, 8, kind)


class _Seen(dryrun.Trace):
    """A trace that also counts the operations it receives during sharding
    propagation."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.propagating = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.propagating += bool(dryrun._PROPAGATING[0])
        return super().__torch_dispatch__(func, types, args, kwargs)


def test_one_sharded_mm_is_counted_at_its_local_flops():
    """(64, 32) rows over pod and data against (32, 48) columns over model:
    the rank's product is (16, 32) @ (32, 24), 2·16·32·24 FLOPs, its bytes
    the local operands' and result's; the propagation that placed it ran
    under the mode (its cache cleared) and added nothing."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    with mesh.mesh_rank(SMOKE) as m:
        a = distribute_tensor(torch.empty(64, 32, device="meta"), m,
                              (Shard(0), Shard(0), Replicate()))
        b = distribute_tensor(torch.empty(32, 48, device="meta"), m,
                              (Replicate(), Replicate(), Shard(1)))
        DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
        trace = _Seen()
        with dryrun._outside_propagation(), trace:
            c = a @ b
        assert c.placements == (Shard(0), Shard(0), Shard(1))
        assert tuple(c.to_local().shape) == (16, 24)
    assert trace.propagating > 0
    assert dict(trace.flops) == {"float32": 2 * 16 * 32 * 24}
    assert trace.bytes == 4 * (16 * 32 + 32 * 24 + 16 * 24)
    assert trace.calls == []  # no collective: each operand's shards already fit


def test_attention_is_counted_on_the_ranks_own_rows_and_heads(monkeypatch):
    """granite smoke's prefill (8 x 16, 4 query and 2 KV heads, D 16) on a
    (pod 2, data 2, model 2) mesh: the head rule hands the meta route the
    rank's 2 rows and its 2 query heads over 1 KV head, each layer's call
    counted at 4·D a visible pair of those, where one device's trace counts
    its 2 rows at all 4 heads."""
    from repro_torch.kernels import flash_attention as fa

    shapes, counted = [], []
    real_kernel, real_count = fa.flash_attention_kernel, dryrun.Trace.kernel

    def seen(q, k, v, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return real_kernel(q, k, v, **kw)

    def count(self, entry, flops, nbytes, dtype):
        counted.append(flops)
        return real_count(self, entry, flops, nbytes, dtype)

    monkeypatch.setattr(fa, "flash_attention_kernel", seen)
    monkeypatch.setattr(dryrun.Trace, "kernel", count)
    cfg = _smoke("granite-3-8b")
    pairs = fa.visible_pairs(16, 16, True, None)
    for dtensor, heads in ((None, 2), (False, 4)):
        shapes.clear()
        counted.clear()
        rec = dryrun.cell_record(dryrun.build_cell("granite-3-8b", _shape("prefill"),
                                                   mesh=SMOKE, config=cfg, dtensor=dtensor))
        assert shapes == [((2, heads, 16, 16), (2, heads // 2, 16, 16))] * cfg.n_layers
        assert counted == [4.0 * 16 * 2 * heads * pairs] * cfg.n_layers
        assert rec["kernel_entries"] == {"flash_attention_f32": cfg.n_layers}


@pytest.mark.parametrize("arch,kind", [("qwen1.5-0.5b", "train"),
                                       ("jamba-1.5-large-398b", "prefill"),
                                       ("mixtral-8x22b", "decode")])
def test_a_world_of_ones_trace_equals_one_devices(arch, kind):
    """On a (pod 1, data 1, model 1) world the per-rank trace runs the DTensor
    path over one rank: the same FLOPs and argument bytes as one device's
    trace, its peak within PEAK_BAND of one device's, no collective kept
    (each spans a group of one rank)."""
    world = {"pod": 1, "data": 1, "model": 1}
    cfg = _smoke(arch)
    rank = dryrun.cell_record(dryrun.build_cell(arch, _shape(kind), mesh=world, config=cfg,
                                                dtensor=True))
    plain = dryrun.cell_record(dryrun.build_cell(arch, _shape(kind), mesh=world, config=cfg))
    assert (rank["analysis"], plain["analysis"]) == ("per-rank-trace", "meta-trace")
    assert rank["temp_bound"] is None and rank["collectives"] == {}
    assert rank["flops_by_dtype"] == plain["flops_by_dtype"]
    assert rank["argument_bytes"] == plain["argument_bytes"]
    assert rank["kernel_entries"] == plain["kernel_entries"]
    ratio = rank["memory"]["temp_size_in_bytes"] / plain["memory"]["temp_size_in_bytes"]
    assert PEAK_BAND[0] <= ratio <= PEAK_BAND[1], ratio


@pytest.mark.parametrize("arch,shape,multi", [("qwen1.5-0.5b", "decode_32k", False),
                                              ("qwen1.5-0.5b", "decode_32k", True),
                                              ("xlstm-350m", "long_500k", True)])
def test_production_ranks_hold_the_specs_argument_bytes(arch, shape, multi):
    """Rank 0 of the 256- or 512-rank mesh holds, leaf by leaf placed by the
    run time's functions, the bytes the specs give (``_rank_trace`` checks
    each tree and fails the cell otherwise): the record is the rank's."""
    rec = dryrun.cell_record(dryrun.build_cell(arch, shape, multi))
    assert rec["analysis"] == "per-rank-trace" and rec["temp_bound"] is None
    assert rec["chips"] == (512 if multi else 256) and rec["model_split"] == 16
    assert rec["memory"]["temp_size_in_bytes"] > 0 and rec["collectives"]


def test_a_leaf_placed_against_its_spec_fails_the_cell(monkeypatch):
    """``place_params`` replicating every leaf: the rank holds more than the
    specs say, and the trace refuses to go on."""
    real = sharding.param_pspecs

    def whole(params, rules):
        return {k: (None,) * len(s) for k, s in real(params, rules).items()}

    cell = dryrun.build_cell("qwen1.5-0.5b", "decode_32k", False)
    monkeypatch.setattr(sharding, "param_pspecs", whole)
    with pytest.raises(AssertionError, match="params: the rank holds"):
        dryrun.cell_record(cell)
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ARCHS)
def test_a_smoke_train_steps_per_rank_temp_is_at_most_its_undivided_temp(arch):
    """Each arch's smoke train step (prefill for the encoder) on a (pod 2,
    data 2, model 2) mesh: the rank's peak at most one device's trace at
    the same per-device batch and the model's full widths. (Not every cell
    keeps this at production sizes: a decode step on the head_dim cache
    gathers K and V whole, an MoE prefill every rank's tokens; PERF.md.)"""
    cfg = _smoke(arch)
    shape = _shape("prefill" if cfg.encoder_only else "train")
    rank = dryrun.cell_record(dryrun.build_cell(arch, shape, mesh=SMOKE, config=cfg))
    whole = dryrun.cell_record(dryrun.build_cell(arch, shape, mesh=SMOKE, config=cfg,
                                                 dtensor=False))
    assert rank["analysis"] == "per-rank-trace" and whole["temp_bound"]
    assert rank["memory"]["temp_size_in_bytes"] <= whole["memory"]["temp_size_in_bytes"]


def test_the_fake_group_goes_after_a_trace_and_a_present_group_is_refused(tmp_path):
    rec = dryrun.cell_record(dryrun.build_cell("granite-3-8b", _shape("prefill"), mesh=SMOKE,
                                               config=_smoke("granite-3-8b")))
    assert rec["analysis"] == "per-rank-trace" and not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="a default process group exists"):
            with mesh.mesh_rank(SMOKE):
                pass
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    # A failure inside the window destroys the group all the same.
    with pytest.raises(KeyError):
        with mesh.mesh_rank(SMOKE):
            assert dist.get_world_size() == 8
            raise KeyError("inside")
    assert not dist.is_initialized()


def test_knobs_without_a_dtensor_counterpart_keep_one_devices_trace():
    for knob in ({"zero": True}, {"zero3": True}, {"accum": 2}):
        meta = dryrun.build_cell("granite-3-8b", "train_4k", False, **knob).meta
        name = next(iter(knob))
        assert meta["analysis"] == "meta-trace"
        assert meta["temp_bound"].startswith(f"--{name}:"), meta["temp_bound"]
        with pytest.raises(ValueError, match="no DTensor counterpart"):
            dryrun.build_cell("granite-3-8b", "train_4k", False, dtensor=True, **knob)
    for meta in (dryrun.build_cell("granite-3-8b", "train_4k", False, dp_only=True).meta,
                 dryrun.build_cell("granite-3-8b", "train_4k",
                                   mesh={"data": 4, "model": 1}).meta):
        assert (meta["analysis"], meta["temp_bound"]) == ("meta-trace", None)
        assert set(meta["collectives"]) == {"all-reduce"}
    meta = dryrun.build_cell("granite-3-8b", "train_4k", False, moe_gather=True).meta
    assert meta["analysis"] == "per-rank-trace"


def test_a_failing_per_rank_trace_makes_the_cli_exit_1(tmp_path, monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("the rank's step failed")

    monkeypatch.setattr(dryrun, "_rank_trace", broken)
    rc = dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--mesh", "single",
                      "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1 and "[dryrun] FAIL qwen1.5-0.5b/decode_32k" in out
    assert "the rank's step failed" in out and os.listdir(tmp_path) == []
    assert not dist.is_initialized()
