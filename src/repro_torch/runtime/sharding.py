"""Named-axis sharding rules, and placement over a ``DeviceMesh``.

Counterpart of ``repro/runtime/sharding.py``. The reference runs SPMD from
one controller over a ``jax.sharding.Mesh``; the port runs one process a
device under ``torch.distributed`` (started by ``torchrun`` or a test's
spawn: NCCL on ``cuda``, gloo on ``cpu``, rank r on ``cuda:LOCAL_RANK``),
with a ``torch.distributed.device_mesh.DeviceMesh`` and DTensor in
GSPMD's place.

**Spec functions.** Parameters are matched by leaf name against an ordered
list of candidate dimensions to shard over the ``model`` axis (the table is
the reference's, copied); the first candidate whose size divides the axis
wins, else the leaf replicates (mixtral's 8 experts do not divide a 16-way
model axis, so its expert FFNs shard ``d_ff``). ``param_pspecs``,
``batch_pspec``, ``cache_pspecs`` and ``zero_pspecs`` take the port's
trees (the ``Model`` state dict, a batch dict, the per-layer cache list)
and return a spec a leaf: a tuple with one entry a dimension, an axis name,
a tuple of names, or ``None``. The reference stacks each block leaf over
the periods of its layer scan; the port keeps one tensor a layer, so a port
leaf's spec is the reference's without its leading period entry. Two
consequences: ``replicate_below`` counts a layer's elements, not the
stack's, and ``zero_pspecs`` never shards a period axis (a port leaf has
none), so where the reference's data axes land on the periods, the port's
land on the first layer dimension that divides. :class:`ShardingRules`
takes a ``DeviceMesh`` or a plain mapping of axis sizes, so the spec
functions need no process group. :func:`placements` turns a spec into
DTensor placements on a mesh.

**Activations.** :func:`make_activation_sharder` makes the reference's
spec decision (``spec``), the dp-only binding (the model axis folded into
the data axes) never naming an axis twice. The ``Model`` calls it at the
reference's sites (``embed``, ``residual``, ``moe_in``, ``logits``): a
DTensor activation is redistributed to its spec's placements (left as it
is where the spec is None, as the reference leaves it unconstrained); a
plain tensor passes through while the model axis has size 1 and raises
above, having no mesh to be placed on.

**Model-axis execution.** :func:`named` and :func:`device_put` are the
reference's ``named(mesh, spec_tree)`` and ``jax.device_put``: a state
dict, a cache list or a batch dict becomes DTensors by its spec function;
:func:`place_params` puts a ``Model``'s parameters on the mesh by
``param_pspecs``. ``runtime/elastic.py::build_pod_mesh`` makes the
``(pod, data, model)`` mesh. A train step then runs on DTensors
(``runtime/steps.py``: the data axes reduce through autograd over a
batch sharded on them), and so do the model's prefill and decode step;
each op keeps the reference's global semantics (DTensor's propagation,
the kernel ops' rules of ``kernels/ops.py::sharded``, the MoE's explicit
expert-parallel path).

**Placement.** ``data_mesh(n)`` is a 1-D mesh over ranks ``0..n-1``,
``host_data_mesh`` the ``(host, data)`` grid. ``place_args`` keeps the
reference's contract: a ``shard`` request distributes each declared
``batch_dims`` input as ``Shard(dim)`` and replicates the rest, and
degrades to ``replicate`` (returned as the effective mode) when the
workload declares none or no declared dimension divides the mesh.
Outside an initialized process group one device is available.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "ShardingRules",
    "param_pspecs",
    "batch_pspec",
    "cache_pspecs",
    "zero_pspecs",
    "placements",
    "make_activation_sharder",
    "named",
    "device_put",
    "place_params",
    "data_mesh",
    "init_distributed",
    "host_data_mesh",
    "available_devices",
    "rank",
    "replicate",
    "workload_pspecs",
    "shard_applies",
    "place_args",
    "reduce_max",
]

# name -> ordered candidate shard dims (on the per-layer leaf shape).
_PARAM_RULES: dict[str, tuple[int, ...]] = {
    "embed": (0,),  # (V, d): vocab-shard
    "unembed": (1,),  # (d, V)
    # attention
    "wq": (1,), "wk": (1,), "wv": (1,), "wo": (0,),
    "bq": (0,), "bk": (0,), "bv": (0,),
    # dense mlp
    "w_gate": (1,), "w_up": (1,), "w_down": (0,),
    # moe (expert-stacked weights): prefer EP on the expert dim, else d_ff
    "moe.w_gate": (0, 2), "moe.w_up": (0, 2), "moe.w_down": (0, 1),
    "router": (),
    # mamba
    "in_proj": (1,), "x_proj": (0,), "dt_w": (1,), "dt_b": (0,),
    "A_log": (0,), "D": (0,), "out_proj": (0,),
    "conv_w": (1,), "conv_b": (0,),
    # mlstm
    "w_gates": (0,), "b_gates": (), "gn": (0,),
    # slstm: block-diagonal recurrent mats shard their output dim
    "w_x": (1,), "r_z": (2,), "r_i": (2,), "r_f": (2,), "r_o": (2,), "b": (),
    "w_ff1": (1,), "w_ff2": (0,),
    # norms
    "ln": (), "ln1": (), "ln2": (), "ln_f": (),
}

Spec = tuple  # one entry a dimension: an axis name, a tuple of names, or None


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """The reference's rules; ``mesh`` is a ``DeviceMesh`` (named dims) or a
    mapping of axis name to size (shape-only, no process group)."""

    mesh: Any
    model_axis: str = "model"
    data_axes: tuple[str, ...] = ("data",)
    seq_shard: bool = False
    # Replicate leaves below this element count (0 disables).
    replicate_below: int = 0
    # Shard decode KV caches over their sequence dim instead of head_dim.
    cache_seq_shard: bool = False
    # Gather the MoE FFN input to data-only sharding before dispatch.
    moe_gather_tokens: bool = False

    @property
    def axis_sizes(self) -> dict[str, int]:
        if isinstance(self.mesh, Mapping):
            return dict(self.mesh)
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    @property
    def model_size(self) -> int:
        return self.axis_sizes[self.model_axis]

    @property
    def data_size(self) -> int:
        sizes = self.axis_sizes
        return math.prod(sizes[a] for a in self.data_axes)


def _param_spec(name: str, shape: tuple[int, ...], rules: ShardingRules) -> Spec:
    leaf = name.rsplit(".", 1)[-1]
    key = leaf
    # Expert-stacked FFN weights have one rank more than the dense MLP's.
    if leaf in ("w_gate", "w_up", "w_down") and len(shape) == 3:
        key = "moe." + leaf
    spec: list = [None] * len(shape)
    if rules.replicate_below and math.prod(shape) < rules.replicate_below:
        return tuple(spec)
    m = rules.model_size
    for d in _PARAM_RULES.get(key, ()):
        if shape[d] % m == 0 and shape[d] >= m:
            spec[d] = rules.model_axis
            break
    return tuple(spec)


def param_pspecs(params: Mapping[str, Any], rules: ShardingRules) -> dict[str, Spec]:
    """A spec a leaf of a ``Model`` state dict (tensors on any device,
    ``meta`` included: the dry run's path)."""
    return {name: _param_spec(name, tuple(t.shape), rules) for name, t in params.items()}


def batch_pspec(batch: Mapping[str, Any], rules: ShardingRules) -> dict[str, Spec]:
    """The batch dim over the data axes when it divides (decode at batch 1
    replicates)."""

    def spec(t) -> Spec:
        shape = tuple(t.shape)
        if not shape or shape[0] % max(rules.data_size, 1) != 0:
            return ()
        return (rules.data_axes,) + (None,) * (len(shape) - 1)

    return {k: spec(t) for k, t in batch.items()}


def cache_pspecs(cache: list[dict], rules: ShardingRules) -> list[dict]:
    """Decode-cache specs, one dict a layer: dim 0 is the batch (over the
    data axes when it divides), and the last dim (head_dim, d_inner,
    d_model, a state width) goes over ``model`` when it divides, or a KV
    entry's sequence dim under ``cache_seq_shard``."""

    def spec(t) -> Spec:
        shape = tuple(t.shape)
        if len(shape) < 2:
            return ()
        dims: list = [None] * len(shape)
        d, m = rules.data_size, rules.model_size
        if shape[0] % max(d, 1) == 0 and shape[0] >= d:
            dims[0] = rules.data_axes
        if rules.cache_seq_shard and len(shape) == 4 and shape[1] % m == 0 and shape[1] >= m:
            dims[1] = rules.model_axis
        elif shape[-1] % m == 0 and shape[-1] >= m:
            dims[-1] = rules.model_axis
        return tuple(dims)

    return [{k: spec(t) for k, t in entry.items()} for entry in cache]


def zero_pspecs(param_specs: Mapping[str, Spec], params: Mapping[str, Any],
                rules: ShardingRules) -> dict[str, Spec]:
    """ZeRO-1: each parameter spec with the data axes on its first
    unsharded dim that divides (optimizer moments over data and model)."""

    def extend(spec: Spec, shape: tuple[int, ...]) -> Spec:
        dims = list(spec) + [None] * (len(shape) - len(spec))
        d = rules.data_size
        for i, entry in enumerate(dims):
            if entry is None and shape[i] % max(d, 1) == 0 and shape[i] >= d:
                dims[i] = rules.data_axes
                break
        return tuple(dims)

    return {k: extend(param_specs[k], tuple(t.shape)) for k, t in params.items()}


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements for ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim a tensor dim ``d`` names (in a tuple entry, the major axis
    first, as the reference's ``P(("pod", "data"))``), ``Replicate()`` on
    the rest."""
    from torch.distributed.tensor import Replicate, Shard

    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                owner[axis] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in mesh.mesh_dim_names)


class _ActivationSharder:
    """The ``shard_activation`` hook: ``spec(shape, name)`` is the
    reference's decision; a call redistributes a DTensor to it (the module
    docstring's "Activations")."""

    def __init__(self, rules: ShardingRules) -> None:
        self.rules = rules
        dp = rules.data_axes
        # The dp-only binding folds the model axis into data; it is then
        # unavailable for vocab or sequence sharding (one axis, one use).
        self._dp = dp
        self._mdl = rules.model_axis if rules.model_axis not in dp else None

    def spec(self, shape: tuple[int, ...], name: str) -> Spec | None:
        """The activation's spec, or None where the reference leaves it
        unconstrained."""
        r, dp, mdl = self.rules, self._dp, self._mdl
        if len(shape) == 3:  # (B, T, d) or (B, T, V)
            b, t, _ = shape
            bspec = dp if b % r.data_size == 0 else None
            if name == "logits":
                return (bspec, None, mdl)
            if name == "moe_in":
                return (bspec, None, None) if r.moe_gather_tokens else None
            if r.seq_shard and t % r.model_size == 0:
                return (bspec, mdl, None)
            return (bspec, None, None)
        if len(shape) == 2:  # decode: (B, d) or (B, V)
            bspec = dp if shape[0] % r.data_size == 0 else None
            return (bspec, mdl if name == "logits" else None)
        return None

    def __call__(self, x: torch.Tensor, name: str) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            spec = self.spec(tuple(x.shape), name)
            if spec is None:
                return x
            return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))
        if self._mdl is not None and self.rules.axis_sizes.get(self._mdl, 1) > 1:
            raise ValueError(
                f"a plain tensor at {name!r} with a model axis of {self.rules.model_size}: "
                "there is no mesh to place it on (place the model and its inputs, "
                "place_params and device_put)"
            )
        return x


def make_activation_sharder(rules: ShardingRules) -> _ActivationSharder:
    return _ActivationSharder(rules)


def named(mesh, spec_tree):
    """Placements on ``mesh`` for each spec of ``spec_tree`` (a dict of
    specs, or a list of them: a cache's), the reference's ``named``."""
    if isinstance(spec_tree, Mapping):
        return {k: placements(v, mesh) for k, v in spec_tree.items()}
    return [named(mesh, entry) for entry in spec_tree]


def device_put(tree, placement_tree, mesh):
    """``tree`` (a dict of tensors, or a list of them) as DTensors with the
    placements of ``placement_tree`` (:func:`named`): a plain tensor is
    distributed (every rank holds the same values, as the seeded inputs
    do; a ``meta`` tensor stays on ``meta``, the dry run's shards), a
    DTensor redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(tree, Mapping):
        return [device_put(t, p, mesh) for t, p in zip(tree, placement_tree, strict=True)]
    out = {}
    for k, t in tree.items():
        pl = placement_tree[k]
        if isinstance(t, DTensor):
            out[k] = t.redistribute(mesh, pl)
        else:
            out[k] = distribute_tensor(t if t.is_meta else t.to(mesh.device_type), mesh, pl)
    return out


def place_params(model: torch.nn.Module, mesh, rules: ShardingRules) -> dict[str, Spec]:
    """Every parameter of ``model`` replaced, under its name, by a DTensor
    parameter placed by ``param_pspecs``; -> the specs."""
    params = dict(model.named_parameters())
    specs = param_pspecs(params, rules)
    placed = device_put({k: p.detach() for k, p in params.items()}, named(mesh, specs), mesh)
    for name, value in placed.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        owner.register_parameter(leaf, torch.nn.Parameter(value))
    return specs


# -- process groups and meshes ------------------------------------------------


def init_distributed(device: str = "cuda") -> bool:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address in the
    environment): NCCL on ``cuda`` (rank r on ``cuda:LOCAL_RANK``), gloo on
    ``cpu``. True when a group is (or already was) initialized; False in a
    single process started without those variables."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device == "cuda" else "gloo")
    return True


def available_devices() -> int:
    """Devices a plan may span: the world's ranks, or 1 outside a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def data_mesh(n_devices: int | None = None, axis: str = "data"):
    """A 1-D mesh over ranks ``0..n-1`` (all by default). Every rank of the
    world must call it (it makes the sub-group); ranks outside get a mesh
    whose ``get_coordinate()`` is None."""
    from torch.distributed.device_mesh import DeviceMesh

    avail = available_devices()
    n = avail if n_devices is None else n_devices
    if not 1 <= n <= avail:
        raise ValueError(f"requested {n} devices but only {avail} available")
    return DeviceMesh(_mesh_device_type(), list(range(n)), mesh_dim_names=(axis,))


def host_data_mesh(n_hosts: int, devices_per_host: int | None = None,
                   axes: tuple[str, str] = ("host", "data")):
    """A 2-D ``(host, data)`` mesh over contiguous groups of ranks: ``data``
    varies fastest, so collectives over it stay inside a host."""
    from torch.distributed.device_mesh import DeviceMesh

    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    avail = available_devices()
    per = devices_per_host
    if per is None:
        if avail % n_hosts:
            raise ValueError(f"{avail} devices do not divide into {n_hosts} hosts; "
                             "pass devices_per_host explicitly")
        per = avail // n_hosts
    need = n_hosts * per
    if need > avail:
        raise ValueError(f"requested {n_hosts} hosts x {per} devices = {need}, "
                         f"but only {avail} available")
    return DeviceMesh(_mesh_device_type(), torch.arange(need).reshape(n_hosts, per),
                      mesh_dim_names=axes)


def reduce_max(values: list[float], group) -> list[float]:
    """Each value's maximum over ``group``'s ranks (one all-reduce)."""
    device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()


# -- workload placement -------------------------------------------------------


def _distribute(leaf, mesh, placement):
    from torch.distributed.tensor import distribute_tensor

    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(leaf)
    if not isinstance(leaf, torch.Tensor):
        return leaf  # a Python scalar (a seed) is the same on every rank
    # Rank 0's values: a Shard scatters them, a Replicate broadcasts them.
    return distribute_tensor(leaf.to(mesh.device_type), mesh, placement)


def replicate(tree, mesh):
    """Every tensor of a tuple, list or dict fully replicated over
    ``mesh``."""
    from torch.distributed.tensor import Replicate

    rep = (Replicate(),) * mesh.ndim
    if isinstance(tree, Mapping):
        return {k: _distribute(v, mesh, rep) for k, v in tree.items()}
    return type(tree)(_distribute(v, mesh, rep) for v in tree)


def workload_pspecs(workload, mesh, axis: str = "data") -> tuple:
    """Per-input placements from a workload's ``batch_dims``: ``Shard(dim)``
    where one is declared, ``Replicate()`` elsewhere. Divisibility is
    checked at placement (``place_args``), not here."""
    from torch.distributed.tensor import Replicate, Shard

    dims = workload.batch_dims
    if dims is None:
        raise ValueError(
            f"workload {workload.name!r} declares no batch_dims; "
            "sharded placement must fall back to replicate"
        )
    if mesh.mesh_dim_names != (axis,):
        raise ValueError(f"a workload shards over a 1-D {axis!r} mesh, got "
                         f"{mesh.mesh_dim_names}")
    return tuple((Replicate(),) if d is None else (Shard(d),) for d in dims)


def _divides(arg, dim: int | None, n: int) -> bool:
    shape = tuple(getattr(arg, "shape", ()))
    return dim is not None and len(shape) > dim and shape[dim] % n == 0


def shard_applies(args: tuple, workload, n_devices: int) -> bool:
    """Shape-only: would a ``shard`` placement partition anything?"""
    if not workload.batchable:
        return False
    if len(workload.batch_dims) != len(args):
        raise ValueError(
            f"workload {workload.name!r} declares {len(workload.batch_dims)} "
            f"batch_dims but make_inputs produced {len(args)} inputs"
        )
    return any(_divides(a, d, n_devices) for a, d in zip(args, workload.batch_dims))


def place_args(args: tuple, workload, mesh, mode: str) -> tuple[tuple, str]:
    """``(placed args, effective mode)``: a ``shard`` request on a workload
    without ``batch_dims``, or whose declared dims do not divide the mesh,
    degrades to ``replicate``."""
    if mode == "shard" and shard_applies(args, workload, mesh.size()):
        from torch.distributed.tensor import Replicate

        placed = tuple(
            _distribute(a, mesh, p if _divides(a, d, mesh.size()) else (Replicate(),))
            for a, d, p in zip(args, workload.batch_dims, workload_pspecs(workload, mesh))
        )
        return placed, "shard"
    return replicate(tuple(args), mesh), "replicate"
