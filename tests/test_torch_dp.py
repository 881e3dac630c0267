"""Data-parallel training (``launch/train.py --mesh``) over gloo worlds on
the CPU, held to one process.

qwen1.5-0.5b's smoke config in f32: 2 and 4 ranks, each holding its rows of
the global batch (``Prefetch(sharding=...)``) and mean-all-reducing every
gradient and the loss before clipping and AdamW, take the one-process run's
steps within the training path's bound (2e-4 + 2e-4·|ref| on every loss,
gradient norm and parameter; ``tests/test_torch_train.py``). A checkpoint
that rank 0 wrote under 4 ranks restores under 2 and continues the
one-process run. ``build_mesh`` makes the (data, model) grid over the
world, and each rank's prefetched rows tile the global batch.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.launch.train import train
from torch_world import run_world

ARCH = "qwen1.5-0.5b"
RUN = dict(arch=ARCH, steps=6, batch=8, seq=16, lr=1e-3, seed=0, device="cpu", log_every=0)
TOL = 2e-4  # rtol and atol, the training path's bound


def _world(tmp_path, world: int, script: str) -> dict:
    """Run ``script`` on ``world`` ranks; rank 0's result.json and params."""
    before = set(tmp_path.glob("world-*"))
    run_world(script, world, tmp_path)
    (out,) = set(tmp_path.glob("world-*")) - before
    return (json.loads((out / "result.json").read_text()),
            torch.load(out / "params.pt", weights_only=True))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


@pytest.fixture(scope="module")
def reference():
    """The one-process run: 6 steps (the schedule spans 6 in every run)."""
    out = train(**RUN)
    return out["losses"], out["grad_norms"], {k: v.clone() for k, v in out["params"].items()}


_SCRIPT = """
        import json
        from repro_torch.launch.train import train

        out = train(use_mesh=True, **json.loads(%r))
        if RANK == 0:
            json.dump({"losses": out["losses"], "grad_norms": out["grad_norms"]},
                      open(os.path.join(OUT, "result.json"), "w"))
            torch.save(out["params"], os.path.join(OUT, "params.pt"))
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """4 ranks: their (2, 2) mesh and prefetched rows, a batch of 6 refused,
    then the first 3 steps, rank 0 saving a checkpoint at step 3. -> (rank
    0's result, the checkpoint directory, the refusal's message)."""
    tmp_path = tmp_path_factory.mktemp("four_ranks")
    ckpt = tmp_path / "ckpt"
    got, _ = _world(tmp_path, 4, """
        import numpy as np
        from repro_torch.data import Prefetch, SyntheticLM
        from repro_torch.launch.train import train
        from repro_torch.runtime.elastic import build_mesh

        mesh = build_mesh(None, 2, 2)
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (2, 2)
        assert list(mesh.get_coordinate()) == [RANK // 2, RANK % 2], mesh.get_coordinate()
        data = SyntheticLM(vocab=64, batch=8, seq=4, seed=1)
        pf = Prefetch(data.batch_at, start_step=5, sharding=mesh["data"], device="cpu")
        step, mine = next(iter(pf))
        pf.close()
        rows = [None] * WORLD
        dist.all_gather_object(rows, mine["tokens"].numpy())
        assert step == 5 and np.array_equal(np.concatenate(rows[::2]), data.batch_at(5)["tokens"])
        assert np.array_equal(rows[0], rows[1]) and np.array_equal(rows[2], rows[3])
        try:
            train(use_mesh=True, arch="qwen1.5-0.5b", steps=1, batch=6, seq=4, device="cpu",
                  log_every=0)
            refused = "not refused"
        except ValueError as e:
            refused = str(e)
        if RANK == 0:
            with open(os.path.join(OUT, "refused.txt"), "w") as f:
                f.write(refused)
    """ + _SCRIPT % json.dumps(dict(RUN, stop_after=3, checkpoint_dir=str(ckpt), save_every=3)))
    (out,) = tmp_path.glob("world-4-*")
    return got, ckpt, (out / "refused.txt").read_text()


def test_a_batch_the_world_does_not_divide_is_refused(four_ranks):
    """Batch 6 over 4 ranks: no leaf is left whole for every rank to train on."""
    msg = four_ranks[2]
    assert "batch 6" in msg and "world size 4" in msg, msg


def test_dp_training_at_four_ranks(four_ranks, reference):
    got, ckpt, _ = four_ranks
    losses, norms, _ = reference
    _close(got["losses"], losses[:3], "4-rank losses")
    _close(got["grad_norms"], norms[:3], "4-rank gradient norms")
    from repro_torch.checkpoint import Checkpointer

    assert Checkpointer(str(ckpt)).latest_step() == 3


def test_dp_training_at_two_ranks(tmp_path, reference):
    got, _ = _world(tmp_path, 2, _SCRIPT % json.dumps(dict(RUN, stop_after=3)))
    losses, norms, _ = reference
    _close(got["losses"], losses[:3], "2-rank losses")
    _close(got["grad_norms"], norms[:3], "2-rank gradient norms")


def test_a_four_rank_checkpoint_restores_under_two_ranks(tmp_path, four_ranks, reference):
    """2 ranks resume rank 0's step-3 checkpoint of 4 ranks and end where one
    process ends, parameter for parameter."""
    _, ckpt, _ = four_ranks
    got, got_params = _world(tmp_path, 2, _SCRIPT % json.dumps(dict(
        RUN, checkpoint_dir=str(ckpt), resume=True)))
    losses, norms, params = reference
    _close(got["losses"], losses[3:], "2-rank losses after the 4-rank checkpoint")
    _close(got["grad_norms"], norms[3:], "2-rank gradient norms after the 4-rank checkpoint")
    assert set(got_params) == set(params)
    for name, want in params.items():
        _close(got_params[name].numpy(), want.numpy(), name)
