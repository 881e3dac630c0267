"""The model axis at run time, shared by ``tests/test_torch_model_axis_*.py``.

The reference's ``tests/test_distributed.py::test_production_sharding_on_
mini_mesh`` (which fails in the reference itself: the port is held to its
docstring): a ``(pod 2, data 2, model 2)`` mesh, ``ShardingRules(mesh,
data_axes=("pod", "data"), seq_shard=True)``, the smoke configs of
granite-3-8b, mixtral-8x22b, jamba-1.5-large-398b and xlstm-350m in f32,
``remat=True``, batch 8 x 16, a cache of 32 positions.

The reference's side runs here on one CPU device; its weights go to the
ranks through ``convert.model_state_from_reference`` as files in the
world's ``OUT``, with the batch (a numpy generator of a fixed seed). The
ranks (``tests/torch_world.py``, gloo, one interpreter a rank) place the
model, batch and caches by ``param_pspecs``, ``batch_pspec`` and
``cache_pspecs`` through ``runtime/sharding.py`` and run the port's steps
on DTensors; rank 0 writes every result read back whole
(``full_tensor()``), every rank the DTensor rules its attention took and
the model-sharded leaves it holds whole (none expected).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_state_from_reference
from repro_torch.models import Model
from torch_world import start_world

ARCHS = ("granite-3-8b", "mixtral-8x22b", "jamba-1.5-large-398b", "xlstm-350m")
MESH = (2, 2, 2)  # (pod, data, model)
B, T, MAX_LEN = 8, 16, 32
LR = 1e-3  # a constant schedule: the docstring's warmup gives step 0 no update
TOL = 2e-4  # rtol and atol: the training path's bound (ROADMAP.md, "Parity")
# Seconds a world may take: alone one takes ~80 s, beside the other test
# workers of a parallel run several times that.
DEADLINE = 480.0
COMM_ARCH = "granite-3-8b"  # the world whose collectives are counted


def configs(arch: str):
    """(the reference's config, the port's), the smoke config in f32."""
    return (dataclasses.replace(ref_smoke_config(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def reference(arch: str):
    """(the reference's model, its parameters, the port's state dict of
    them, the batch as numpy arrays): no compilation, so the world can start
    from them before the reference's side is computed."""
    rcfg, cfg = configs(arch)
    ref = RefModel(rcfg, remat=True)
    params = ref.init(jax.random.key(0))
    state = model_state_from_reference(cfg, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab, (B, T), dtype=np.int32) for k in ("tokens", "labels")}
    return ref, params, state, batch


def port_model(arch: str, state: dict) -> Model:
    """The port's one-process model (plain tensors, the CPU) on ``state``."""
    model = Model(configs(arch)[1], device="cpu")
    model.load_state_dict(state)
    return model


def n_attention(arch: str) -> int:
    return sum(k.startswith("attn") for k in configs(arch)[1].block_kinds())


def close(got, want, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=TOL, atol=TOL,
                               err_msg=what)


def write_inputs(out: Path, arch: str, state: dict, batch: dict) -> None:
    torch.save(state, out / f"{arch}-state.pt")
    torch.save({k: torch.from_numpy(v) for k, v in batch.items()}, out / f"{arch}-batch.pt")


# The ranks' common part: the mesh, the placed model and the helpers. The
# script that follows it sets ARCHS_HERE and runs one function an arch.
PRELUDE = """
import dataclasses
import json

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.runtime import (ShardingRules, batch_pspec, build_pod_mesh, cache_pspecs,
                                 device_put, make_activation_sharder, named, place_params)

mesh = build_pod_mesh(*MESH)
rules = ShardingRules(mesh=mesh, data_axes=("pod", "data"), seq_shard=True)


def place(tree, spec_fn):
    return device_put(tree, named(mesh, spec_fn(tree, rules)), mesh)


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def placed_model(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = Model(cfg, device="cpu", remat=True, shard_activation=make_activation_sharder(rules))
    model.load_state_dict(torch.load(os.path.join(INPUTS, f"{arch}-state.pt")))
    specs = place_params(model, mesh, rules)
    batch = torch.load(os.path.join(INPUTS, f"{arch}-batch.pt"))
    # Every leaf whose spec names the model axis, if this rank holds it whole.
    whole_here = [k for k, p in model.named_parameters()
                  if any(e == "model" for e in specs[k]) and p.to_local().numel() >= p.numel()]
    return model, specs, batch, whole_here


def counts(mode):
    return {str(op).split(".")[-1]: n for op, n in mode.get_comm_counts().items() if n}


def report(arch, what, **fields):
    fields["rules"] = {f"{op}/{rule}": n for (op, rule), n in ops.dtensor_rules.items()}
    with open(os.path.join(OUT, f"{arch}-{what}-rank{RANK}.json"), "w") as f:
        json.dump(fields, f)
"""


def start_model_axis_world(script: str, inputs: Path, tmp_path: Path):
    """``script`` (after :data:`PRELUDE`, with the inputs' directory as
    ``INPUTS``) started on the ``MESH`` world; its ``.wait(DEADLINE)``
    collects it, its ``.out`` is the ranks' ``OUT``."""
    head = (f"MESH = {MESH!r}\nARCHS_HERE = {ARCHS!r}\nINPUTS = {str(inputs)!r}\n"
            f"B, T, MAX_LEN, COMM_ARCH = {B!r}, {T!r}, {MAX_LEN!r}, {COMM_ARCH!r}\n")
    return start_world(head + PRELUDE + script, int(np.prod(MESH)), tmp_path)


def rank_reports(out: Path, arch: str, what: str) -> list[dict]:
    return [json.loads((out / f"{arch}-{what}-rank{r}.json").read_text())
            for r in range(int(np.prod(MESH)))]


def held_to_the_dry_run(out: Path, kind: str) -> None:
    """COMM_ARCH's counted step (``comm-<kind>.json``, rank 0's
    ``CommDebugMode``) against ``dryrun.collectives`` for the same mesh
    sizes, per-device batch and sequence: each collective's count."""
    from repro_torch.launch import dryrun
    from repro_torch.runtime.sharding import ShardingRules, param_pspecs

    measured = json.loads((out / f"comm-{kind}.json").read_text())
    names = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}
    got = {names[k]: n for k, n in measured.items()}
    cfg = configs(COMM_ARCH)[1]
    sizes = dict(zip(("pod", "data", "model"), MESH))
    rules = ShardingRules(mesh=sizes, data_axes=("pod", "data"), seq_shard=True)
    params = dict(Model(cfg, device="meta").named_parameters())
    want = dryrun.collectives(cfg, kind, rules, params=params,
                              p_specs=param_pspecs(params, rules),
                              batch=B // (sizes["pod"] * sizes["data"]),
                              seq=T if kind == "train" else 1)
    assert got == {op: int(h["count"]) for op, h in want.items()}, (got, want)
