"""``chip_smoke.py``'s full-width MoE check (phase 4k,
``_moe_teacher_forced``) on the CPU, at a small width.

On the card the check holds the kernel route against the plain route one
layer at a time, each layer fed the plain route's input, and bounds each
row whose experts agree at ``MOE_LAYER_ULPS`` bf16 ulps of its largest
value. Here the kernel route is stood in for by the plain attention with
one-ulp changes put on a share of its output elements, which is what the
card's attention kernel does (phase 3 holds it within one ulp): the check
must pass at every share, keep the two routes' caches bit-equal, and fail
on an attention that is 64 ulps off.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import Model

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


def _attention_off_by(monkeypatch, share: float, ulps: float) -> None:
    """``ops.attention`` outside ``force_impl("ref")`` moves ``share`` of its
    output elements by ``ulps`` bf16 ulps, up or down."""
    plain = ops.attention
    gen = torch.Generator().manual_seed(5)

    def attention(*args, **kw):
        out = plain(*args, **kw)
        forced = ops._FORCED.get()
        if forced is not None and forced[0] == "ref":
            return out
        f = out.float()
        ulp = chip_smoke._bf16_ulp(torch, f.abs().clamp_min(1e-30))
        pick = torch.rand(f.shape, generator=gen) < share
        sign = torch.where(torch.rand(f.shape, generator=gen) < 0.5, -1.0, 1.0)
        return (f + pick * sign * ulps * ulp).to(out.dtype)

    monkeypatch.setattr(ops, "attention", attention)


@pytest.mark.parametrize("share", [1e-3, 1e-2, 1.0])
def test_an_attention_within_one_ulp_holds_the_per_layer_bounds(monkeypatch, share):
    _attention_off_by(monkeypatch, share, 1.0)
    tally = chip_smoke._moe_teacher_forced(torch, _model(), TEACHER)
    assert tally["rows"] == TEACHER["prompt_len"] + chip_smoke.LM_TEACHER_STEPS
    assert 0 < tally["worst_ulps"] <= chip_smoke.MOE_LAYER_ULPS
    assert tally["share"] <= chip_smoke.MOE_FLIP_SHARE


def test_the_same_attention_on_both_routes_reads_zero():
    tally = chip_smoke._moe_teacher_forced(torch, _model(), TEACHER)
    assert tally["worst_ulps"] == 0.0 and tally["flipped"] == 0


def test_an_attention_64_ulps_off_fails_the_check(monkeypatch):
    _attention_off_by(monkeypatch, 1.0, 64.0)
    with pytest.raises(SystemExit, match="ulps from the plain route"):
        chip_smoke._moe_teacher_forced(torch, _model(), TEACHER)


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
