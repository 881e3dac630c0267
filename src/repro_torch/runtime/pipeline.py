"""GPipe-style pipeline parallelism over the ``pod`` axis.

Counterpart of ``repro/runtime/pipeline.py``. The pod axis defaults to
extra data parallelism; this module is the alternative binding: the layer
stack is split into P contiguous stages, rank ``s`` of the axis running the
layers ``[s·L_s, (s+1)·L_s)`` of the stacked parameters, and microbatches
flow stage to stage over M + P − 1 ticks (the GPipe schedule: P − 1 bubble
ticks). Where the reference hands an activation on with ``lax.ppermute``,
the port sends it to rank s + 1 mod P of the axis's process group by
``torch.distributed`` point-to-point (``batch_isend_irecv``: each rank's send
and receive in flight together, so a ring of gloo ranks cannot deadlock);
where it sums with ``lax.psum``, the port all-reduces over that group. On a
``(pod, data, model)`` mesh (``runtime/elastic.py::build_pod_mesh``) each
(data, model) coordinate runs its own pipeline over its pod ranks.

The pipeline is differentiable, as the reference's is under ``jax.grad``:
the hand-off is an autograd function whose backward hands the cotangent back
the other way, and the all-reduce passes its cotangent through, as JAX
transposes ``psum`` into a replicated value: the result is the same on every
rank, so each rank's loss of it must be the same too (its cotangent is the
whole one). A rank's gradient of the stacked parameters is non-zero only on
its own slice.

This is the cross-pod traffic shape-changer: data parallelism over the pod
axis moves the full gradient every step over the slow link; the pipeline
moves only microbatch activations (mb × T × d a tick).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_leaves, tree_map

__all__ = ["gpipe_forward", "stacked_blocks"]


class _Shift(torch.autograd.Function):
    """Send ``x`` to the next rank of ``group``'s ring and return what the
    previous rank sent; the backward hands the cotangent the other way."""

    @staticmethod
    def _exchange(x: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
        got = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, to), group),
               dist.P2POp(dist.irecv, got, dist.get_global_rank(group, frm), group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return got

    @staticmethod
    def forward(ctx, x, group, stage, n_stages):
        ctx.ring = (group, stage, n_stages)
        return _Shift._exchange(x, group, (stage + 1) % n_stages, (stage - 1) % n_stages)

    @staticmethod
    def backward(ctx, grad):
        group, stage, n_stages = ctx.ring
        return (_Shift._exchange(grad, group, (stage - 1) % n_stages, (stage + 1) % n_stages),
                None, None, None)


class _Emit(torch.autograd.Function):
    """The tick's result summed over ``group``: ``out`` where this rank
    emits, zeros elsewhere. The sum is replicated, so its cotangent passes
    through to the emitting rank's ``out``."""

    @staticmethod
    def forward(ctx, out, group, emits):
        ctx.emits = emits
        total = out.clone() if emits else torch.zeros_like(out)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.emits else torch.zeros_like(grad)), None, None


class _Ingest(torch.autograd.Function):
    """Stage 0's input: the microbatch. The activation handed to it is
    unused, but its hand-off stays in the graph (a zero cotangent), so that
    the backward's exchange with the last stage and with stage 1 runs on
    stage 0 too."""

    @staticmethod
    def forward(ctx, mb, act):
        return mb.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, torch.zeros_like(grad)


def gpipe_forward(stage_fn: Callable, mesh, *, axis: str = "pod") -> Callable:
    """-> ``f(stacked_params, x_microbatches)`` running the pipeline.

    ``stage_fn(stage_params, x) -> x``. ``stacked_params``: a tensor or a
    pytree of them (dicts, lists, tuples) whose leaves have a leading dim of
    P·L_s (P the size of ``mesh``'s ``axis``); every rank holds them whole
    and runs its own slice. ``x_microbatches``: (M, mb, ...), the same on
    every rank. -> (M, mb, ...), the last stage's results, the same on every
    rank."""
    dim = mesh.mesh_dim_names.index(axis)
    n_stages = mesh.size(dim)
    stage = mesh.get_local_rank(dim)
    group = mesh.get_group(dim)

    def stage_slice(leaf: torch.Tensor) -> torch.Tensor:
        per = leaf.shape[0] // n_stages
        return leaf[stage * per:(stage + 1) * per]

    def pipelined(stacked_params, x_mb: torch.Tensor) -> torch.Tensor:
        for leaf in tree_leaves(stacked_params):
            if leaf.shape[0] % n_stages:
                raise ValueError(f"a leading dim of {leaf.shape[0]} does not split into "
                                 f"{n_stages} stages over {axis!r}")
        stage_params = tree_map(stage_slice, stacked_params)
        m = x_mb.shape[0]
        ticks = m + n_stages - 1
        act = torch.zeros_like(x_mb[0])  # the activation entering this stage this tick
        results = []
        for t in range(ticks):
            # Stage 0 ingests microbatch t (clamped; bubbles are never emitted).
            mb = x_mb[min(t, m - 1)]
            if stage > 0:
                inp = act
            elif n_stages > 1:
                inp = _Ingest.apply(mb, act)
            else:
                inp = mb
            out = stage_fn(stage_params, inp)
            # The last stage's result for microbatch t - (P - 1).
            emits = t >= n_stages - 1 and stage == n_stages - 1
            emitted = _Emit.apply(out, group, emits)
            if t >= n_stages - 1:
                results.append(emitted)
            # Hand the activation on (the last tick's would enter no stage).
            if t < ticks - 1:
                act = _Shift.apply(out, group, stage, n_stages) if n_stages > 1 else out
        return torch.stack(results)  # (M, mb, ...)

    return pipelined


class _Layer(nn.Module):
    """A block of a model as a module whose forward is the model's own block
    code (``Model._block``), so ``torch.func.functional_call`` can run it on
    a layer's slice of the stacked parameters."""

    def __init__(self, model, block) -> None:
        super().__init__()
        self.block = block
        self._run = model._block

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return self._run(self.block, x, positions)[0]


def stacked_blocks(model) -> tuple[dict, Callable]:
    """A model's layers as a pipeline's input: -> (stacked parameters, each
    leaf the layers' copies stacked on a new leading dim; ``stage_fn``,
    which runs the model's block code over a stage's layers on x (mb, T, d),
    positions ``arange(T)`` as ``Model.forward`` gives them). Every layer
    must be of one kind."""
    kinds = {block.kind for block in model.blocks}
    if len(kinds) != 1:
        raise ValueError(f"stacked layers must be of one kind; {model.cfg.name} has "
                         f"{sorted(kinds)}")
    names = [name for name, _ in model.blocks[0].named_parameters()]
    stacked = {name: torch.stack([dict(block.named_parameters())[name].detach()
                                  for block in model.blocks]) for name in names}
    layer = _Layer(model, model.blocks[0])
    mrope = model.cfg.rope == "mrope"

    def stage_fn(stage_params: dict, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[:2]
        positions = torch.arange(t, device=x.device).expand(b, t)
        if mrope:
            positions = positions[..., None].expand(b, t, 3)
        for i in range(next(iter(stage_params.values())).shape[0]):
            x = torch.func.functional_call(
                layer, {f"block.{k}": v[i] for k, v in stage_params.items()}, (x, positions))
        return x

    return stacked, stage_fn
