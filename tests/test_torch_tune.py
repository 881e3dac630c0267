"""The port's tune stage and its on-disk winners, on the CPU.

Ports the passing tune tests of ``tests/test_impl_tune.py`` onto the port's
engine (a seeded sweep is deterministic with ``_time_tune_trial`` pinned, a
tie keeps the first candidate, the stage is a no-op for ``torch`` and for
one-entry spaces) and holds ``core/hlocache.py`` to the contract of the
reference's docstrings (``repro/core/engine.py`` ``_stage_tune``,
``repro/core/hlocache.py``): a cold run stores one winner, a warm engine on
the same directory restores it at zero trials, an unusable sidecar is
counted and swept again. Then what the port adds: a candidate the kernel
refuses before launching (``TileRefused``) is skipped and counted, and the
winner's parameters reach ``force_impl``.

On the CPU both f32 GEMM tiles run the plain version, so the sweep's
timing is pinned wherever a test needs a particular winner.
"""

import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import engine as engine_mod
from repro_torch.core import hlocache, suite
from repro_torch.core.engine import Engine
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.registry import get_benchmark
from repro_torch.core.results import load_run
from repro_torch.kernels import matmul, ops

SPACE = ops.tune_space("matmul")
NARROW, WIDE = SPACE  # 128 x 128 (the defaults), 128 x 256


def _plan(names=("gemm_f32_nn",), **kw):
    base = dict(names=names, preset=0, iters=1, warmup=0, include_backward=False,
                impl="kernel", tune=True, device="cpu")
    return ExecutionPlan(**{**base, **kw})


def _one(eng: Engine, plan: ExecutionPlan):
    (rec,) = eng.run(plan).records
    return rec


def _pin_trials(monkeypatch, times):
    """Candidate i of each sweep costs times[i]."""
    calls = []

    def fake_trial(self, entry, args, plan):
        calls.append(None)
        return times[(len(calls) - 1) % len(times)]

    monkeypatch.setattr(Engine, "_time_tune_trial", fake_trial)
    return calls


# -- the sweep -----------------------------------------------------------------


def test_plan_tune_defaults_off_and_untuned_rows_are_unchanged():
    assert ExecutionPlan().tune is False
    eng = Engine()
    rec = _one(eng, _plan(tune=False))
    assert rec.status == "ok", rec.error
    assert (rec.tuned_params, rec.tune_trials, rec.tune_trials_us) == (None, None, None)
    assert "tuned=" not in rec.csv() and "tune_refused" not in rec.derived
    assert set(rec.stage_timings_us) == {"build", "place", "compile", "measure", "characterize"}
    (key,) = eng.cache._entries
    assert len(key) == 9 and key[-1] == ()


def test_tuner_is_deterministic_for_a_fixed_seed(monkeypatch):
    calls = _pin_trials(monkeypatch, [5.0, 1.0])
    recs = [_one(Engine(), _plan()) for _ in range(2)]
    for rec in recs:
        assert rec.status == "ok", rec.error
        assert rec.tuned_params == WIDE and rec.tune_trials == len(SPACE)
        assert rec.tune_trials_us is not None and rec.tune_trials_us > 0
        assert "tuned=block_m=128/block_n=256;tune_trials=2;tune_us=" in rec.csv()
        assert set(rec.stage_timings_us) >= {"tune", "compile", "measure"}
    assert len(calls) == 2 * len(SPACE)


def test_tuner_tie_keeps_the_earliest_candidate(monkeypatch):
    _pin_trials(monkeypatch, [1.0, 1.0])
    assert _one(Engine(), _plan()).tuned_params == NARROW


def test_tune_is_a_noop_for_torch_and_untunable_passes():
    rec = _one(Engine(), _plan(impl="torch"))
    assert rec.status == "ok" and rec.impl == "torch"
    assert rec.tuned_params is None and rec.tune_trials is None
    # One-entry spaces win by default at zero trials.
    for name, want in (("srad", {}), ("softmax", {}), ("where", ops.tune_space("prefix_scan")[0])):
        rec = _one(Engine(), _plan(names=(name,)))
        assert rec.status == "ok", rec.error
        assert rec.tuned_params == want and rec.tune_trials == 0 and rec.tune_trials_us == 0.0
    # A kernel plan's backward pass runs torch: nothing to tune there.
    fwd, bwd = Engine().run(_plan(names=("softmax",), include_backward=True)).records
    assert fwd.tune_trials == 0 and bwd.impl == "torch" and bwd.tuned_params is None


def test_the_tuned_params_join_the_cache_key_and_reach_force_impl(monkeypatch):
    _pin_trials(monkeypatch, [5.0, 1.0])
    seen = []
    real = ops.force_impl

    @contextlib.contextmanager
    def spy(mode, op=None, **params):
        seen.append((mode, op, params))
        with real(mode, op, **params):
            yield

    monkeypatch.setattr(engine_mod.kernel_ops, "force_impl", spy)
    eng = Engine()
    rec = _one(eng, _plan())
    assert rec.tuned_params == WIDE
    assert {key[-1] for key in eng.cache._entries} == {
        tuple(sorted(NARROW.items())), tuple(sorted(WIDE.items()))}
    # The winner's compile was the sweep's entry: a hit, not a second build.
    assert eng.cache.misses == len(SPACE) and eng.cache.hits == 1
    # Measure-stage calls (validation, timing) ran under the winner's tile.
    assert seen[-1] == ("kernel", "matmul", WIDE)
    assert ("kernel", "matmul", NARROW) in seen


@pytest.mark.parametrize("tile", [NARROW, WIDE], ids=["128x128", "128x256"])
def test_each_tile_computes_the_rows_product(tile):
    wl = get_benchmark("gemm_f32_tn").build_preset(0)
    args = wl.make_inputs(0)
    got = engine_mod.bind_impl(wl.fn, wl, "kernel", tile)(*args)
    want = engine_mod.bind_impl(wl.fn, wl, "torch")(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# -- refusals --------------------------------------------------------------------


def _refuse(monkeypatch, refused_block_n, exc=ops.TileRefused):
    """matmul_kernel raises ``exc`` for ``block_n=refused_block_n`` before
    doing anything, as an entry without that tile does on the card."""
    real = matmul.matmul_kernel

    def kernel(a, b, **blocks):
        if blocks.get("block_n") == refused_block_n:
            raise exc(f"no compiled tile (128, {refused_block_n})")
        return real(a, b, **blocks)

    monkeypatch.setattr(matmul, "matmul_kernel", kernel)


def test_a_refused_candidate_is_skipped_and_counted(monkeypatch):
    calls = _pin_trials(monkeypatch, [1.0])
    _refuse(monkeypatch, 256)
    rec = _one(Engine(), _plan(names=("gemm_bf16_nn",)))
    assert rec.status == "ok", rec.error
    assert rec.tuned_params == NARROW and rec.tune_trials == 1 and len(calls) == 1
    assert rec.derived.endswith(";tune_refused=1") and "tune_refused=1" in rec.csv()


def test_a_refused_first_candidate_fails_the_row(monkeypatch):
    _refuse(monkeypatch, 128)
    rec = _one(Engine(), _plan())
    assert rec.status == "error" and rec.derived == "stage=tune"
    assert "TileRefused" in rec.error


def test_any_other_error_in_a_candidate_fails_the_row(monkeypatch):
    _refuse(monkeypatch, 256, exc=RuntimeError)
    rec = _one(Engine(), _plan())
    assert rec.status == "error" and rec.derived == "stage=tune"
    assert "RuntimeError" in rec.error


def test_the_matmul_entries_refuse_a_tile_they_do_not_compile_before_the_device():
    rng = np.random.default_rng(0)
    bf16 = [torch.from_numpy(rng.standard_normal((64, 64), dtype=np.float32)).bfloat16()
            for _ in range(2)]
    f32 = [torch.from_numpy(rng.standard_normal((64, 64), dtype=np.float32)) for _ in range(2)]
    assert matmul._route(*bf16) == "matmul_bf16" and matmul._route(*f32) == "matmul_f32"
    with pytest.raises(ops.TileRefused, match="no compiled tile"):
        matmul.matmul_cuda(*bf16, block_n=256)
    with pytest.raises(ops.TileRefused, match="no compiled tile"):
        matmul.matmul_cuda(*f32, block_m=64, block_n=128)
    # matmul_f32 compiles 128 x 256: the next check is the device's.
    with pytest.raises(ValueError, match="needs CUDA tensors") as info:
        matmul.matmul_cuda(*f32, block_n=256)
    assert not isinstance(info.value, ops.TileRefused)
    # A view TMA cannot read routes to the SIMT entry, which has 128 x 128 alone.
    wide = torch.zeros(64, 66)[:, :63]
    assert matmul._route(wide, f32[1][:63]) == "matmul_f32_simt"
    with pytest.raises(ops.TileRefused):
        matmul.matmul_cuda(wide, f32[1][:63], block_n=256)


# -- the disk cache --------------------------------------------------------------


def _sidecars(root: str) -> list[str]:
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".tune.json")]


def test_tuned_winner_persists_and_warm_run_skips_the_sweep(tmp_path, monkeypatch):
    _pin_trials(monkeypatch, [5.0, 1.0])
    cold = Engine(cache_dir=str(tmp_path))
    rec = _one(cold, _plan())
    assert rec.status == "ok", rec.error
    assert rec.tune_trials == 2 and rec.tuned_params == WIDE
    assert cold.disk_cache.counter_dict() == {"tune_hits": 0, "tune_stores": 1, "tune_fallbacks": 0}
    (path,) = _sidecars(str(tmp_path))
    assert json.load(open(path))["params"] == WIDE
    warm = Engine(cache_dir=str(tmp_path))
    rec2 = _one(warm, _plan())
    assert rec2.status == "ok", rec2.error
    assert rec2.tune_trials == 0 and rec2.tune_trials_us == 0.0
    assert rec2.tuned_params == rec.tuned_params
    assert warm.disk_cache.tune_hits == 1 and warm.disk_cache.tune_stores == 0
    assert warm.cache.misses == 1  # the winner alone was built
    # Keyed on the plan: another row, device or preset misses.
    rec3 = _one(warm, _plan(names=("gemm_f32_tn",)))
    assert rec3.tune_trials == 2 and warm.disk_cache.tune_stores == 1


@pytest.mark.parametrize("payload", [
    "{not json",
    json.dumps({"format": 99, "params": WIDE, "trials": 2, "trials_us": 1.0}),
    json.dumps({"format": 1, "params": {"block_m": 128, "block_n": 512}, "trials": 2,
                "trials_us": 1.0}),
    json.dumps({"format": 1, "params": {"block_m": 128, "block_n": "256"}, "trials": 2,
                "trials_us": 1.0}),
    json.dumps({"format": 1, "trials": 2}),
    json.dumps([1, 2]),
], ids=["unparseable", "stale_format", "not_a_candidate", "not_an_int", "no_params", "a_list"])
def test_an_unusable_sidecar_is_counted_and_swept_again(tmp_path, monkeypatch, payload):
    _pin_trials(monkeypatch, [5.0, 1.0])
    _one(Engine(cache_dir=str(tmp_path)), _plan())
    (path,) = _sidecars(str(tmp_path))
    with open(path, "w") as f:
        f.write(payload)
    eng = Engine(cache_dir=str(tmp_path))
    rec = _one(eng, _plan())
    assert rec.status == "ok", rec.error
    assert rec.tune_trials == 2 and rec.tuned_params == WIDE
    stats = eng.disk_cache.counter_dict()
    assert stats == {"tune_hits": 0, "tune_stores": 1, "tune_fallbacks": 1}
    assert eng.disk_cache.last_tune_fallback.startswith("gemm_f32_nn: ")
    assert "last_tune_fallback=[gemm_f32_nn: " in eng.disk_cache.summary()
    # Swept again and stored: the next engine hits.
    again = Engine(cache_dir=str(tmp_path))
    assert _one(again, _plan()).tune_trials == 0 and again.disk_cache.tune_hits == 1


def test_the_cache_directory_is_versioned_by_device_torch_and_source(tmp_path, monkeypatch):
    here = hlocache.HloDiskCache(str(tmp_path)).root
    assert os.path.basename(here).startswith(f"torch-{torch.__version__}-cuda-")
    assert "-cpu-" in os.path.basename(here) or torch.cuda.is_available()
    monkeypatch.setattr(hlocache.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(hlocache.torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    card = hlocache.HloDiskCache(str(tmp_path)).root
    assert card != here and "NVIDIA_H100_80GB_HBM3" in card
    # The source digest sees Python files and kernel sources, nothing else.
    pkg = tmp_path / "pkg"
    (pkg / "kernels" / "csrc").mkdir(parents=True)
    (pkg / "a.py").write_text("x = 1\n")
    (pkg / "kernels" / "csrc" / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(hlocache, "_PKG_ROOT", pkg)
    first = hlocache._source_digest()
    (pkg / "notes.txt").write_text("unrelated")
    assert hlocache._source_digest() == first
    (pkg / "kernels" / "csrc" / "k.cu").write_text("// v2\n")
    assert hlocache._source_digest() != first


# -- the suite CLI ----------------------------------------------------------------


def _cli(tmp_path, label, *extra):
    jsonl = str(tmp_path / f"{label}.jsonl")
    rc = suite.main(["--names", "gemm_f32_nn", "--preset", "0", "--impl", "kernel",
                     "--device", "cpu", "--no-backward", "--iters", "1", "--warmup", "0",
                     "--jsonl", jsonl, *extra])
    meta, records = load_run(jsonl)
    return rc, meta, records


def test_suite_cli_tune_and_cache_dir(tmp_path, capsys):
    cache = str(tmp_path / "cache")
    rc, meta, (rec,) = _cli(tmp_path, "cold", "--tune", "--cache-dir", cache)
    assert rc == 0 and rec.status == "ok", rec.error
    assert meta.tune is True and rec.tune_trials == 2 and rec.tuned_params in SPACE
    assert meta.cache_stats == {"tune_hits": 0, "tune_stores": 1, "tune_fallbacks": 0}
    out = capsys.readouterr()
    assert "tune_trials=2" in out.out and "# hlocache: tune_hits=0 tune_stores=1" in out.err
    rc, meta, (warm,) = _cli(tmp_path, "warm", "--tune", "--cache-dir", cache)
    assert rc == 0 and warm.tune_trials == 0 and warm.tuned_params == rec.tuned_params
    assert meta.cache_stats == {"tune_hits": 1, "tune_stores": 0, "tune_fallbacks": 0}
    assert "# hlocache: tune_hits=1 tune_stores=0" in capsys.readouterr().err
    # --tune on a torch plan changes nothing; no --cache-dir, no counters.
    rc, meta, (plain,) = _cli(tmp_path, "torch", "--tune", "--impl", "torch")
    assert rc == 0 and plain.impl == "torch" and plain.tuned_params is None
    assert meta.cache_stats is None
    assert "hlocache" not in capsys.readouterr().err


def test_run_suite_takes_an_engine_or_a_cache_dir_not_both(tmp_path):
    with pytest.raises(ValueError, match="not both"):
        suite.run_suite(names=["gemm_f32_nn"], device="cpu", engine=Engine(),
                        cache_dir=str(tmp_path))
    recs = suite.run_suite(names=["gemm_f32_nn"], preset=0, iters=1, warmup=0, impl="kernel",
                           tune=True, device="cpu", include_backward=False, verbose=False,
                           cache_dir=str(tmp_path))
    assert [r.tune_trials for r in recs] == [2] and len(_sidecars(str(tmp_path))) == 1


def test_the_final_meta_line_carries_the_cache_counters(tmp_path, monkeypatch):
    _pin_trials(monkeypatch, [1.0, 5.0])
    jsonl = str(tmp_path / "r.jsonl")
    eng = Engine(cache_dir=str(tmp_path / "c"))
    eng.run(_plan(), jsonl_path=jsonl)
    lines = [json.loads(line) for line in open(jsonl)]
    assert [line["kind"] for line in lines] == ["meta", "record", "meta"]
    assert lines[0]["cache_stats"] is None and lines[-1]["cache_stats"]["tune_stores"] == 1
    meta, _ = load_run(jsonl)
    assert dataclasses.asdict(meta)["cache_stats"] == lines[-1]["cache_stats"]
