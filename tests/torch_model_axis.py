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
``cache_pspecs`` (under ``rules``, or ``seq_rules``: the cache split on its
sequence, ``cache_seq_shard``) through ``runtime/sharding.py`` and run the
port's steps on DTensors; rank 0 writes every result read back whole
(``full_tensor()``) and each arch's collectives (``CommLog``: each one's
operation, operand, bytes and mesh dim) of its train step, its prefill
under the production rules (no sequence sharding: ``serve_rules``) and its
decode step on each cache layout, every rank the DTensor rules its
attention took and the model-sharded leaves it holds whole (none
expected). :func:`held_to_the_dry_run` holds each log, count for count and
byte for byte, to the dry run's trace of rank 0 of the same mesh on a
``"fake"`` process group (``launch/dryrun.py``).
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
COMM_ARCH = "granite-3-8b"  # the arch whose cache collectives are checked one by one


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
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.runtime import (ShardingRules, batch_pspec, build_pod_mesh, cache_pspecs,
                                 device_put, make_activation_sharder, named, place_params)

mesh = build_pod_mesh(*MESH)
rules = ShardingRules(mesh=mesh, data_axes=("pod", "data"), seq_shard=True)
# A prefill's production rules (the dry run's: the sequence is not sharded).
serve_rules = ShardingRules(mesh=mesh, data_axes=("pod", "data"))
# The same, with a decode cache split on its sequence instead of head_dim.
seq_rules = ShardingRules(mesh=mesh, data_axes=("pod", "data"), seq_shard=True,
                          cache_seq_shard=True)


def place(tree, spec_fn, with_rules=rules):
    return device_put(tree, named(mesh, spec_fn(tree, with_rules)), mesh)


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


COMM_OPS = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor", "all_to_all_single")
# A collective's process group by name -> the mesh dim it spans.
GROUPS = {mesh.get_group(i).group_name: name for i, name in enumerate(mesh.mesh_dim_names)}


# Each functional collective a step issues: [op, its operand's elements, its
# bytes by the reference's convention (an all-gather its result, a
# reduce-scatter and an all-to-all their operand, an all-reduce 2 x its
# result), the mesh dim it spans]. A dispatch mode of its own:
# CommDebugMode's module tracker fails on some of the models' modules when
# used more than once a step kind.
class CommLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs first and issues the collectives
        out = func(*args, **(kwargs or {}))
        op = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "c10d_functional") and op in COMM_OPS:
            x = args[0]
            result = out.numel() * out.element_size()
            operand = x.numel() * x.element_size()
            nbytes = {"all_reduce": 2 * result, "reduce_scatter_tensor": operand,
                      "all_to_all_single": operand}.get(op, result)
            self.calls.append([op, x.numel(), nbytes, GROUPS.get(args[-1])])
        return out


def write_comm(mode, what):  # rank 0's calls of a CommLog
    if RANK == 0:
        with open(os.path.join(OUT, f"comm-{what}.json"), "w") as f:
            json.dump(mode.calls, f)


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


COMM_NAMES = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
              "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


def _histogram(calls) -> tuple[dict, dict]:
    """({op: {"count", "bytes"}}, {"<op> over <mesh dim>": {"count", "bytes"}})."""
    by_op, by_dim = {}, {}
    for op, nbytes, dim in calls:
        for hist, key in ((by_op, op), (by_dim, f"{op} over {dim}")):
            h = hist.setdefault(key, {"count": 0, "bytes": 0})
            h["count"] += 1
            h["bytes"] += nbytes
    return by_op, by_dim


def held_to_the_dry_run(out: Path, arch: str, kind: str, what: str | None = None,
                        cache_seq_shard: bool = False) -> list:
    """``arch``'s logged step (``comm-<arch>-<what>.json``, ``what`` the
    kind by default; rank 0's ``CommLog``) against the dry run's per-rank
    trace of the same smoke config, batch, sequence and cache on a fake
    world of ``MESH`` (a decode step at the cache's last position, where
    the world's is at ``T``: no collective depends on it, the split rule's
    rank 0 holding no slot at either): each collective's count and bytes,
    by operation and by mesh dim, equal. -> the logged calls."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import ShapeSpec

    calls = json.loads((out / f"comm-{arch}-{what or kind}.json").read_text())
    got = _histogram([(COMM_NAMES[op], nbytes, dim) for op, _, nbytes, dim in calls])
    shape = ShapeSpec(f"smoke_{kind}", MAX_LEN if kind == "decode" else T, B, kind)
    cell = dryrun.build_cell(arch, shape, mesh=dict(zip(("pod", "data", "model"), MESH)),
                             config=configs(arch)[1], cache_seq_shard=cache_seq_shard)
    rec = dryrun.cell_record(cell)
    assert rec["analysis"] == "per-rank-trace" and rec["temp_bound"] is None, rec["analysis"]
    want = (rec["collectives"], rec["collectives_by_mesh_dim"])
    assert got == want, (arch, what or kind, got, want)
    return calls
