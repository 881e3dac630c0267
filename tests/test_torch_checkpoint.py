"""The port's checkpointer (``repro_torch.checkpoint``) on the CPU: the
reference's own checks (tests/test_checkpoint.py) on torch payloads, and
the on-disk layout shared with the reference's ``Checkpointer`` in both
directions, bit for bit."""

import json
import os
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro_torch.checkpoint import Checkpointer
from repro_torch.optim import AdamW


def _payload(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "w": torch.randn(8, 8, generator=g),
            "b16": torch.randn(4, generator=g).to(torch.bfloat16),
        },
        "cursor": 17,
        "nested": [torch.arange(3), {"x": torch.tensor(2.5)}],
    }


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_roundtrip_exact_bf16_included(tmp_path):
    ck = Checkpointer(str(tmp_path))
    payload = _payload()
    ck.save(17, payload, blocking=True)
    step, restored = ck.restore(_payload(seed=1))
    assert step == 17 and restored["cursor"] == 17
    _assert_same(restored["params"]["w"], payload["params"]["w"])
    _assert_same(restored["params"]["b16"], payload["params"]["b16"])
    _assert_same(restored["nested"][0], payload["nested"][0])
    _assert_same(restored["nested"][1]["x"], payload["nested"][1]["x"])


def test_training_payload_roundtrips_with_the_adamw_state(tmp_path):
    params = {"blocks.0.mixer.wq": torch.randn(4, 6).to(torch.bfloat16), "ln_f": torch.ones(6)}
    opt = AdamW(moment_dtype="bfloat16")
    state = opt.init(params)
    opt.update({k: torch.full_like(p, 0.5) for k, p in params.items()}, state, params, lr=1e-2)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"params": params, "opt": state, "cursor": 3})
    ck.wait()
    fresh = opt.init({k: torch.zeros_like(p) for k, p in params.items()})
    step, out = ck.restore({"params": {k: torch.zeros_like(p) for k, p in params.items()},
                            "opt": fresh, "cursor": 0})
    assert step == 3 and out["cursor"] == 3 and type(out["opt"]).__name__ == "AdamWState"
    _assert_same(out["opt"].step, state.step)
    for k in params:
        _assert_same(out["params"][k], params[k])
        _assert_same(out["opt"].m[k], state.m[k])
        _assert_same(out["opt"].v[k], state.v[k])
    with open(tmp_path / "step_0000000003" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["opt/step"]["dtype"] == "int32" and leaves["opt/step"]["shape"] == []
    assert leaves["opt/m/blocks.0.mixer.wq"]["dtype"] == "bfloat16"
    assert leaves["cursor"] == {"value": 3}


def test_keep_k_prunes_old(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _payload(), blocking=True)
    assert ck.all_steps() == [3, 4]


def test_async_save_then_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _payload(), blocking=False)
    ck.wait()
    assert ck.latest_step() == 5 and len(ck.write_s) == 1


def _hold_the_writer(monkeypatch):
    """Hold each write thread at its first directory until the returned
    event is set, so the test decides what happens before the write."""
    release = threading.Event()
    caller = threading.current_thread()
    makedirs = os.makedirs

    def held(*args, **kwargs):
        if threading.current_thread() is not caller:
            assert release.wait(30), "the writer was never released"
        return makedirs(*args, **kwargs)

    monkeypatch.setattr(os, "makedirs", held)
    return release


def test_async_save_snapshots_the_payload_before_in_place_updates(tmp_path, monkeypatch):
    """CPU tensors and numpy arrays changed in place after ``save`` (as the
    next train step changes parameters and moments) are written as they were
    at ``save``."""
    payload = _payload()
    payload["arr"] = np.arange(6, dtype=np.float32)
    w, b16, arr = payload["params"]["w"], payload["params"]["b16"], payload["arr"]
    before = (w.clone(), b16.clone(), arr.copy())
    ck = Checkpointer(str(tmp_path))
    release = _hold_the_writer(monkeypatch)
    ck.save(1, payload)
    w.add_(1.0)
    b16.mul_(2.0)
    arr += 1.0
    release.set()
    ck.wait()
    _, got = ck.restore(payload)
    _assert_same(got["params"]["w"], before[0])
    _assert_same(got["params"]["b16"], before[1])
    assert got["arr"].dtype == np.float32 and np.array_equal(got["arr"], before[2])


def test_partial_write_is_not_a_checkpoint(tmp_path):
    """A crash mid-save leaves only a .tmp dir, never a corrupt step."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _payload(), blocking=True)
    os.makedirs(tmp_path / ".tmp.99")
    (tmp_path / ".tmp.99" / "leaf_00000.bin").write_bytes(b"junk")
    assert ck.all_steps() == [1]
    step, _ = ck.restore(_payload())
    assert step == 1


def test_shape_mismatch_is_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.zeros(4)}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"w": torch.zeros(5)})


def test_missing_leaf_is_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.zeros(4)}, blocking=True)
    with pytest.raises(KeyError):
        ck.restore({"w": torch.zeros(4), "extra": torch.zeros(1)})


def test_a_failed_async_write_raises_at_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.zeros(4)}, blocking=True)
    (tmp_path / ".tmp.2").write_bytes(b"a file where the writer makes a directory")
    ck.save(2, {"w": torch.zeros(4)})
    with pytest.raises(OSError):
        ck.wait()
    assert ck.all_steps() == [1]


def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.normal(size=(5, 3)).astype(np.float32),
        "b": rng.normal(size=(7,)).astype(ml_dtypes.bfloat16),
        "c": rng.integers(-9, 9, size=(2, 2)).astype(np.int32),
        "d": np.arange(4, dtype=np.int64),
    }


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    tree = _numpy_tree()
    RefCheckpointer(str(tmp_path)).save(9, {**tree, "cursor": 4}, blocking=True)
    template = {k: torch.zeros(v.shape) for k, v in tree.items()}
    step, out = Checkpointer(str(tmp_path)).restore({**template, "cursor": 0})
    assert step == 9 and out["cursor"] == 4
    for k, arr in tree.items():
        got = out[k]
        assert str(got.dtype).replace("torch.", "") == str(arr.dtype)
        want = arr.view(np.int16) if k == "b" else arr
        have = got.view(torch.int16) if k == "b" else got
        np.testing.assert_array_equal(have.numpy(), want)


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    tree = _numpy_tree(1)
    tensors = {k: (torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
                   if k == "b" else torch.from_numpy(v.copy())) for k, v in tree.items()}
    Checkpointer(str(tmp_path)).save(2, {**tensors, "cursor": 11}, blocking=True)
    # numpy leaves, which the reference returns as read (a jax array template
    # would place them on the device, where int64 becomes int32).
    template = {k: np.zeros(v.shape) for k, v in tree.items()}
    step, out = RefCheckpointer(str(tmp_path)).restore({**template, "cursor": 0})
    assert step == 2 and out["cursor"] == 11
    for k, arr in tree.items():
        got = np.asarray(out[k])
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got.view(np.uint8), arr.view(np.uint8))
