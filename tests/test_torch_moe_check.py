"""``chip_smoke.py``'s full-width per-layer check (phases 4k and 4l,
``_layer_teacher_forced``) on the CPU, at a small width.

On the card the check holds the kernel route against the plain route one
layer at a time, each layer fed the plain route's input: a layer without
attention must be bit-equal, and an attention layer bounds each row whose
experts agree at ``LAYER_ULPS`` bf16 ulps of its largest value. Here the
kernel route is stood in for by the plain attention with one-ulp changes
put on a share of its output elements, which is what the card's attention
kernel does (phase 3 holds it within one ulp): the check must pass at every
share, keep the two routes' caches bit-equal, and fail on an attention that
is 64 ulps off, or on a recurrent layer that moves at all.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import Model, ssm

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

TEACHER = dict(batch=1, prompt_len=512, max_len=520)


def _model():
    cfg = dataclasses.replace(
        get_smoke_config("mixtral-8x22b"), dtype="bfloat16", d_model=384, n_heads=12,
        n_kv_heads=2, head_dim=32, d_ff=1024, vocab=2048, n_layers=3, moe_group_size=128,
        window=256)
    model = Model(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    return model.eval()


def _hybrid():
    """jamba's smoke stack in bf16: Mamba layers with MLPs and MoEs, one
    attention layer (4), MoE layers after it."""
    model = Model(get_smoke_config("jamba-1.5-large-398b"), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    return model.eval()


HYBRID_TEACHER = dict(batch=1, prompt_len=128, max_len=136)


def _off_by_ulps(out: torch.Tensor, share: float, ulps: float, gen) -> torch.Tensor:
    f = out.float()
    ulp = chip_smoke._bf16_ulp(torch, f.abs().clamp_min(1e-30))
    pick = torch.rand(f.shape, generator=gen) < share
    sign = torch.where(torch.rand(f.shape, generator=gen) < 0.5, -1.0, 1.0)
    return (f + pick * sign * ulps * ulp).to(out.dtype)


def _kernel_route() -> bool:
    forced = ops._FORCED.get()
    return forced is None or forced[0] != "ref"


def _attention_off_by(monkeypatch, share: float, ulps: float) -> None:
    """``ops.attention`` outside ``force_impl("ref")`` moves ``share`` of its
    output elements by ``ulps`` bf16 ulps, up or down."""
    plain = ops.attention
    gen = torch.Generator().manual_seed(5)

    def attention(*args, **kw):
        out = plain(*args, **kw)
        return _off_by_ulps(out, share, ulps, gen) if _kernel_route() else out

    monkeypatch.setattr(ops, "attention", attention)


@pytest.mark.parametrize("share", [1e-3, 1e-2, 1.0])
def test_an_attention_within_one_ulp_holds_the_per_layer_bounds(monkeypatch, share):
    _attention_off_by(monkeypatch, share, 1.0)
    tally = chip_smoke._layer_teacher_forced(torch, _model(), TEACHER)
    assert tally["rows"] == TEACHER["prompt_len"] + chip_smoke.LM_TEACHER_STEPS
    assert 0 < tally["worst_ulps"] <= chip_smoke.LAYER_ULPS
    assert tally["share"] <= chip_smoke.MOE_FLIP_SHARE


def test_the_same_attention_on_both_routes_reads_zero():
    tally = chip_smoke._layer_teacher_forced(torch, _model(), TEACHER)
    assert tally["worst_ulps"] == 0.0 and tally["flipped"] == 0


def test_an_attention_64_ulps_off_fails_the_check(monkeypatch):
    _attention_off_by(monkeypatch, 1.0, 64.0)
    with pytest.raises(SystemExit, match="ulps from the plain route"):
        chip_smoke._layer_teacher_forced(torch, _model(), TEACHER)


def test_the_layer_feed_leaves_the_model_as_it_was():
    model = _model()
    tokens = torch.arange(16)[None] % model.cfg.vocab
    _, want = model.prefill(tokens, 24)
    with chip_smoke._LayerFeed(model) as plain:
        model.prefill(tokens, 24)
    with chip_smoke._LayerFeed(model, plain.inputs) as fed:
        _, got = model.prefill(tokens, 24)
    assert len(plain.inputs) == len(fed.outputs) == model.cfg.n_layers
    assert torch.equal(got, want)
    assert "_block" not in vars(model) and "_decode_block" not in vars(model)


def test_a_hybrid_stack_holds_its_recurrent_layers_bit_equal(monkeypatch):
    _attention_off_by(monkeypatch, 1.0, 1.0)
    model = _hybrid()
    tally = chip_smoke._layer_teacher_forced(torch, model, HYBRID_TEACHER)
    assert tally["rows"] == HYBRID_TEACHER["prompt_len"] + chip_smoke.LM_TEACHER_STEPS
    assert 0 < tally["worst_ulps"] <= chip_smoke.LAYER_ULPS
    assert tally["flipped"] == tally["selection_flips"] == 0


def test_a_recurrent_layer_that_moves_between_the_routes_fails_the_check(monkeypatch):
    plain = ssm.apply_mamba
    gen = torch.Generator().manual_seed(5)

    def apply_mamba(*args, **kw):
        y, state = plain(*args, **kw)
        return (_off_by_ulps(y, 1.0, 1.0, gen) if _kernel_route() else y), state

    monkeypatch.setattr(ssm, "apply_mamba", apply_mamba)
    with pytest.raises(SystemExit, match=r"prefill, layer \d \(mamba_\w+, no kernel\): the "
                       "routes differ"):
        chip_smoke._layer_teacher_forced(torch, _hybrid(), HYBRID_TEACHER)
