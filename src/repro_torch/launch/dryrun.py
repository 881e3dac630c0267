"""Dry run: every (arch × shape × mesh) cell traced on the meta device, its
per-device memory and its roofline terms.

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and compiles
each cell's SPMD program for 256 or 512 forced host devices and reads
``memory_analysis()`` and ``cost_analysis()``. PyTorch has no SPMD compiler,
so the port traces the cell's step eagerly on tensors of the ``meta``
device (shapes and dtypes, no storage) at the per-device batch and the
model's full widths, with a ``TorchDispatchMode`` (:class:`Trace`) counting
every ATen operation. For each cell it:

1. builds ``Model(cfg, device="meta")`` (AdamW moments in bf16 above 30e9
   parameters, the reference's ``_moment_dtype``), the production mesh's
   axis sizes (``launch/mesh.py``) and the sharding rules of
   ``runtime/sharding.py`` over them;
2. cuts the batch of ``launch/specs.py`` to one device's share under
   ``batch_pspec``;
3. traces ``make_train_step`` (train_4k), ``prefill`` or an encoder's
   ``forward`` (prefill_32k) or ``decode_step`` at the cache's last
   position (decode_32k, long_500k) under ``ops.force_impl("kernel")``, so
   attention takes its meta route (``kernels/flash_attention.py``): the
   flash kernel's output shape and analytic cost, the entry ``_route``
   would take, no score matrix;
4. writes one JSON record per cell under ``artifacts/dryrun_torch/`` (never
   the reference's ``artifacts/dryrun/``), with the reference's keys, so
   ``benchmarks/roofline_table.rows`` renders them.

The record's fields:

- ``memory.argument_size_in_bytes``: exact; the sum of each leaf's local
  shard under ``param_pspecs`` (``zero_pspecs`` under ``--zero3``), the
  AdamW moments' specs (``zero_pspecs`` under ``--zero``) and step,
  ``cache_pspecs`` and ``batch_pspec`` (a decode step's tokens and ``pos``
  replicated, as the reference passes them); ``argument_bytes`` splits it.
- ``memory.temp_size_in_bytes``: the peak of the bytes the trace allocated
  and still held (storages tracked from allocation to release; gradients
  included where they are live), at the per-device batch and full widths.
  Dividing activations over the model axis is item 16.6's, so on a model
  axis of more than 1 the value is an upper bound (``"temp_bound": "model
  axis undivided"``).
- ``cost.flops`` and ``cost["bytes accessed"]``: the trace's counts split
  evenly over the model axis. FLOPs are ``torch.utils.flop_counter``'s
  formulas (products, convolutions) plus the kernel ops' analytic counts,
  and :func:`untraced_scan_flops`, the part of the reference's
  :func:`inner_scan_correction` (the recurrences' elementwise chains) that
  no formula sees. Bytes are the inputs plus the outputs of every operation
  that is not a view or an allocation (``empty``), as XLA's "bytes
  accessed" counts them; a gather (an embedding lookup) reads the rows it
  returns, not its whole table; an in-place write counts once.
- ``collectives``: the reference's histogram keys, counted from the specs
  (:func:`collectives`; item 16.6 must meet or correct these rules):
  training reduces the gradients over the data axes as
  ``runtime/steps.py::_mean_over`` does (one all-reduce a dtype of one flat
  buffer, the loss in the f32 one), or reduce-scatters them and
  all-gathers the parameters under ``--zero`` (once) or ``--zero3`` (once
  a pass); on a model axis of more than 1, each block all-reduces its
  mixer's output and its FFN's output once a pass (forward, the remat
  recomputation, backward), and where the experts shard over the model axis
  the FFN's all-reduce becomes two all-to-alls of the dispatched tokens.
  Bytes follow the reference's convention (``repro/core/metrics.py::
  collective_ops_from_hlo``): an all-reduce 2 × its result, an all-gather
  or a reduce-scatter the gathered bytes, an all-to-all its result.
- ``roofline`` and ``useful_compute_ratio``: as the reference's, at the
  peaks of the card the run sees, each product at its dtype's peak (the
  f32 unembedding at the f32 peak); with ``--device cpu``, the H100 SXM's
  data-sheet peaks, which every record then names in ``peaks``.

**Recurrences.** The recurrent mixers (``models/ssm.py``) loop over time
in Python, one step a token: tracing them at 32768 tokens would take
hours. Their counts are affine in T, but for the backward's bytes, which
are quadratic, so :func:`mixer_plan` traces each mixer alone at four short
lengths and extrapolates its forward and backward FLOPs and bytes, the
bytes autograd saves, and the transient peaks to the cell's T; in the model's trace a stand-in (:class:`_StandIn`)
returns outputs of the right shapes and adds that cost, holding the saved
bytes as the real mixer would.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--force]
  (add --device cpu where there is no CUDA card: data-sheet peaks)
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import sys
import time
import weakref
from typing import Any, Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.metrics import model_flops, peaks_for, roofline_terms
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.launch.specs import SHAPES, ShapeSpec, applicability, input_specs
from repro_torch.models import Model, ssm
from repro_torch.models.layers import dtype_of
from repro_torch.models.moe import capacity
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.runtime.sharding import (
    ShardingRules,
    batch_pspec,
    cache_pspecs,
    param_pspecs,
    zero_pspecs,
)
from repro_torch.runtime.steps import make_train_step

__all__ = [
    "ARTIFACT_DIR",
    "Trace",
    "Cell",
    "build_cell",
    "cell_record",
    "run_cell",
    "inner_scan_correction",
    "untraced_scan_flops",
    "collectives",
    "mixer_plan",
    "main",
]

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                            "dryrun_torch")

aten = torch.ops.aten
# Allocations move no bytes; a gather reads the rows it returns.
_ALLOCATIONS = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
                aten.new_empty.default, aten.new_empty_strided.default}
_GATHERS = {aten.index.Tensor, aten.embedding.default, aten.index_select.default,
            aten.gather.default}
# Operations without a decomposition (found on their first call), and
# prim.device, which the mode must not decompose.
_WHOLE = {torch.ops.prim.device.default}
# The recurrent mixers the stand-ins replace, by block kind.
_MIXERS = {"mamba": "apply_mamba", "mlstm": "apply_mlstm", "slstm": "apply_slstm"}


def _moment_dtype(cfg) -> str:
    # Above 30e9 parameters f32 moments alone exceed a device's share; bf16
    # moments, as the reference's rule (kept for parity).
    return "bfloat16" if cfg.param_counts()["total"] > 30e9 else "float32"


# ---------------------------------------------------------------------------
# The counting mode.
# ---------------------------------------------------------------------------


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an operation's arguments or outputs (tensors, or
    tuples, lists and dicts of them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    for x in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple, dict)):
            out += _tensors(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_key(dtype: torch.dtype) -> str:
    """A product's peak row: the tensor cores' for 16-bit floats, else f32."""
    return "bfloat16" if dtype in (torch.bfloat16, torch.float16) else "float32"


class Trace(TorchDispatchMode):
    """Counts the operations of a trace on meta tensors: FLOPs by their
    inputs' dtype (``flop_registry``'s formulas), bytes (inputs plus new
    outputs of every operation but views and allocations), and the live and
    peak bytes of the storages the trace allocated, each tracked until it is
    released. It is also the attention meta route's counter
    (``kernel(entry, flops, nbytes, dtype)``; ``entries`` counts each entry).
    Operations without a meta tensor (the dry run's own bookkeeping) are not
    counted."""

    def __init__(self) -> None:
        super().__init__()
        self.flops: collections.Counter = collections.Counter()
        self.bytes = 0.0
        self.entries: collections.Counter = collections.Counter()
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}
        self._memo: dict = {}
        self.replays = 0

    def memo(self, key, fn):
        """``fn()`` (returning a tuple of tensors), traced the first time
        ``key`` comes; later calls with ``key`` add the first call's FLOPs
        and bytes, allocate and release its transient peak, and return new
        tensors of its outputs' shapes, strides and dtypes. The attention
        backward's calls come through here (one trace a shape, not a layer)."""
        hit = self._memo.get(key)
        if hit is None:
            flops0, bytes0, live0, peak0 = collections.Counter(self.flops), self.bytes, \
                self.live, self.peak
            self.peak = self.live
            out = fn()
            flops = {k: v - flops0.get(k, 0.0) for k, v in self.flops.items()}
            transient = self.peak - live0 - _storage_bytes(out)
            self.peak = max(peak0, self.peak)
            self._memo[key] = (flops, self.bytes - bytes0, transient,
                               [(tuple(t.shape), t.stride(), t.dtype) for t in out])
            return out
        flops, nbytes, transient, specs = hit
        self.replays += 1
        self.add(flops, nbytes)
        self.transient(transient)
        return tuple(torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                     for shape, stride, dtype in specs)

    def kernel(self, entry: str, flops: float, nbytes: float, dtype: torch.dtype) -> None:
        self.entries[entry] += 1
        self.add({_dtype_key(dtype): flops}, nbytes)

    def add(self, flops: Mapping[str, float], nbytes: float) -> None:
        for key, f in flops.items():
            self.flops[key] += f
        self.bytes += nbytes

    def transient(self, nbytes: int) -> None:
        """A buffer of ``nbytes`` allocated and released at once: the peak
        of work whose parts are not traced one by one."""
        if nbytes > 0:
            torch.empty((int(nbytes),), dtype=torch.uint8, device="meta")

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, t: torch.Tensor, inputs: set) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in inputs or key in self._storages:
            return  # a view of, or a write into, a storage that exists
        n = st.nbytes()
        if n == 0:
            return
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _WHOLE and func._overloadpacket not in flop_registry:
            # Under inference mode a composite (``matmul``) reaches the mode
            # whole: count what it decomposes into, as FlopCounterMode does.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            _WHOLE.add(func)
        out = func(*args, **kwargs)
        ins = _tensors(args) + (_tensors(kwargs) if kwargs else [])
        outs = _tensors(out) if isinstance(out, (list, tuple)) else (
            [out] if isinstance(out, torch.Tensor) else [])
        if not any(t.is_meta for t in ins + outs):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops[_dtype_key(ins[0].dtype)] += flop_registry[packet](
                *args, **kwargs, out_val=out)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        if not (func.is_view or func in _ALLOCATIONS):
            read = sum(_nbytes(t) for t in ins)
            if func in _GATHERS:
                read += sum(_nbytes(t) for t in outs) - _nbytes(ins[0])
            self.bytes += read + sum(_nbytes(t) for t in outs
                                     if t.untyped_storage()._cdata not in in_keys)
        for t in outs:
            self._track(t, in_keys)
        return out


# ---------------------------------------------------------------------------
# The recurrences: short traces, extrapolated.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Cost:
    """One mixer call's counts: FLOPs by dtype, bytes, the forward's
    transient peak, the bytes autograd saves, the backward's counts and
    transient peak (all bytes above what exists before each part)."""

    flops: dict
    nbytes: float
    peak: float
    saved: float = 0.0
    bwd_flops: dict = dataclasses.field(default_factory=dict)
    bwd_nbytes: float = 0.0
    bwd_peak: float = 0.0

    @staticmethod
    def through(costs: list, lengths: tuple, t: int) -> _Cost:
        """Each count at ``t`` on the parabola through three (length, count)
        points (a line where the counts are affine)."""

        def at(*ys: float) -> float:
            total = 0.0
            for i, (xi, yi) in enumerate(zip(lengths, ys)):
                w = 1.0
                for j, xj in enumerate(lengths):
                    if j != i:
                        w *= (t - xj) / (xi - xj)
                total += w * yi
            return total

        def dicts(*ds: dict) -> dict:
            return {k: at(*(d.get(k, 0.0) for d in ds)) for k in set().union(*ds)}

        return _Cost(dicts(*(c.flops for c in costs)), at(*(c.nbytes for c in costs)),
                     at(*(c.peak for c in costs)), at(*(c.saved for c in costs)),
                     dicts(*(c.bwd_flops for c in costs)), at(*(c.bwd_nbytes for c in costs)),
                     at(*(c.bwd_peak for c in costs)))


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _mixer_cost(name: str, params: dict, cfg, b: int, t: int, grad: bool):
    """The real mixer ``ssm.<name>`` alone at (b, t): its counts, its
    outputs' (shape, dtype)s, and its final state's keys."""
    fn = getattr(ssm, name)
    p = {k: v.detach().requires_grad_(grad and v.is_floating_point())
         for k, v in params.items()}
    x = torch.empty((b, t, cfg.d_model), dtype=dtype_of(cfg), device="meta",
                    requires_grad=grad)
    trace = Trace()
    ctx = contextlib.nullcontext() if grad else torch.inference_mode()
    with ctx, trace:
        y, state = fn(p, cfg, x)
        outs = [y, *state.values()]
        cost = _Cost(dict(trace.flops), trace.bytes, trace.peak)
        if grad:
            cost.saved = trace.live - _storage_bytes(outs)
            dy = torch.empty_like(y)
            before = trace.live
            trace.peak, trace.flops, trace.bytes = before, collections.Counter(), 0.0
            wrt = [x, *(v for v in p.values() if v.requires_grad)]
            grads = torch.autograd.grad(y, wrt, grad_outputs=dy, allow_unused=True)
            cost.bwd_flops, cost.bwd_nbytes = dict(trace.flops), trace.bytes
            cost.bwd_peak = trace.peak - before - _storage_bytes(
                [g for g in grads if g is not None])
            del grads, dy
    return cost, [(tuple(o.shape), o.dtype) for o in outs], tuple(state)


def _chunked(cfg, t: int) -> bool:
    """Whether the mLSTM takes its chunked form at length t (models/ssm.py)."""
    c = cfg.xlstm_chunk
    return bool(c) and t % c == 0 and t > c


def _short_lengths(cfg, name: str, t: int, m: int) -> tuple[int, int, int, int]:
    """Four evenly spaced lengths whose traces take the code path the mixer
    takes at t: m to 4m chunks for the chunked mLSTM, else m to 4m tokens
    (each one more where a chunk length is set, so that none is a multiple
    of it)."""
    if name == "apply_mlstm" and _chunked(cfg, t):
        c = cfg.xlstm_chunk
        return tuple(k * m * c for k in (1, 2, 3, 4))
    extra = 1 if cfg.xlstm_chunk > 1 else 0
    return tuple(k * m + extra for k in (1, 2, 3, 4))


@dataclasses.dataclass
class _Plan:
    """A mixer's stand-in at one (batch, length): its extrapolated cost, its
    outputs' shapes and dtypes (y first, then the final state's, under
    ``state_keys``), and whether autograd records it."""

    cost: _Cost
    outputs: list
    state_keys: tuple
    grad: bool


def _close(a: _Cost, b: _Cost) -> bool:
    def near(x: float, y: float) -> bool:
        return abs(x - y) <= 1e-9 * max(abs(x), abs(y), 1.0)

    def dicts(x: dict, y: dict) -> bool:
        return all(near(x.get(k, 0.0), y.get(k, 0.0)) for k in set(x) | set(y))

    return (dicts(a.flops, b.flops) and dicts(a.bwd_flops, b.bwd_flops)
            and all(near(getattr(a, f), getattr(b, f))
                    for f in ("nbytes", "peak", "saved", "bwd_nbytes", "bwd_peak")))


def mixer_plan(name: str, params: dict, cfg, b: int, t: int, grad: bool) -> _Plan:
    """``ssm.<name>`` at (b, t) from traces at four short lengths. The
    forward's counts are affine in T (a peak once its largest part is the
    one that grows fastest); the backward's bytes are quadratic (each step's
    ``select`` of the sequence has a gradient of the whole sequence, which
    autograd adds up). The parabola through the first three lengths must
    meet the fourth, else the lengths double; the one through the last three
    is read at t. The outputs' shapes are the short traces' with T set."""
    m = 2 if name == "apply_mlstm" and _chunked(cfg, t) else 24
    for _ in range(5):
        lengths = _short_lengths(cfg, name, t, m)
        runs = [_mixer_cost(name, params, cfg, b, n, grad) for n in lengths]
        costs = [c for c, _, _ in runs]
        if _close(_Cost.through(costs[:3], lengths[:3], lengths[3]), costs[3]):
            break
        m *= 2
    else:
        raise RuntimeError(f"{name}: its counts do not fit a parabola in T up to {lengths}")
    (_, o2, keys), (_, o3, _) = runs[2], runs[3]
    (y_shape, y_dtype), states = o2[0], o2[1:]
    if states != o3[1:] or o3[0] != ((b, lengths[3], *y_shape[2:]), y_dtype):
        raise AssertionError(f"{name}: a state's shape depends on T ({o2} / {o3})")
    return _Plan(_Cost.through(costs[1:], lengths[1:], t),
                 [((b, t, *y_shape[2:]), y_dtype), *states], keys, grad)


class _StandIn(torch.autograd.Function):
    """A recurrent mixer in the model's trace: outputs of the planned shapes,
    the planned cost added to the trace, the saved bytes held for backward
    as one buffer, each part's transient peak allocated and released."""

    @staticmethod
    def forward(ctx, plan, trace, x, *params):
        cost = plan.cost
        trace.add(cost.flops, cost.nbytes)
        out_bytes = sum(math.prod(s) * d.itemsize for s, d in plan.outputs)
        trace.transient(int(cost.peak - out_bytes - cost.saved))
        outs = [x.new_empty(s, dtype=d) for s, d in plan.outputs]
        if plan.grad:
            ctx.save_for_backward(x.new_empty((max(int(cost.saved), 0),), dtype=torch.uint8))
        ctx.plan, ctx.trace = plan, trace
        ctx.shapes = [(tuple(p.shape), p.dtype, p.requires_grad) for p in params]
        ctx.x = (tuple(x.shape), x.dtype)
        ctx.mark_non_differentiable(*outs[1:])
        return tuple(outs)

    @staticmethod
    def backward(ctx, dy, *_):
        (saved,) = ctx.saved_tensors
        cost = ctx.plan.cost
        ctx.trace.add(cost.bwd_flops, cost.bwd_nbytes)
        ctx.trace.transient(int(cost.bwd_peak))
        del saved
        dx = dy.new_empty(ctx.x[0], dtype=ctx.x[1])
        grads = [dy.new_empty(s, dtype=d) if rg else None for s, d, rg in ctx.shapes]
        return (None, None, dx, *grads)


@contextlib.contextmanager
def _stand_ins(plans: dict, trace: Trace):
    """``ssm.apply_*`` replaced by their stand-ins for the block (the model
    calls them through the module)."""
    saved = {name: getattr(ssm, name) for name in plans}

    def stand_in(plan):
        def apply(p, cfg, x):
            y, *states = _StandIn.apply(plan, trace, x, *p.values())
            return y, dict(zip(plan.state_keys, states, strict=True))

        return apply

    try:
        for name, plan in plans.items():
            setattr(ssm, name, stand_in(plan))
        yield
    finally:
        for name, fn in saved.items():
            setattr(ssm, name, fn)


def _plans(model: Model, b: int, t: int, grad: bool) -> dict:
    """A plan for each recurrent mixer the model has, from its first block
    of that kind."""
    plans = {}
    for block in model.blocks:
        mixer = "mamba" if block.kind.startswith("mamba") else block.kind
        name = _MIXERS.get(mixer)
        if name is None or name in plans:
            continue
        params = dict(block.mixer.items()) if mixer == "mamba" else block.params()
        plans[name] = mixer_plan(name, params, model.cfg, b, t, grad)
    return plans


# ---------------------------------------------------------------------------
# Analytic terms.
# ---------------------------------------------------------------------------


def inner_scan_correction(cfg, batch: int, seq: int, kind: str, chips: int) -> float:
    """The reference's closed form of the *time-recurrence* FLOPs per device
    (``repro/launch/dryrun.py``), ported as is: a = exp(ΔA), b = Δ·B·x,
    h = a·h + b, y = C·h (≈ 8 a Mamba (d_inner, state) cell a token); the
    mLSTM's C = f·C + i·kvᵀ, y = Cq and n (8 a head's dh² a token); the
    sLSTM's recurrent matvecs and gates (8·H·dh² + 20·d). Training × 4
    (backward ≈ 2 × forward, the remat recomputation 1 ×); a decode step
    runs the recurrence once, no correction."""
    if kind == "decode":
        return 0.0
    per_token = 0.0
    for k in cfg.block_kinds():
        if k.startswith("mamba"):
            per_token += 8.0 * cfg.d_inner * cfg.ssm_state
        elif k == "mlstm":
            du = 2 * cfg.d_model
            dh = du // cfg.xlstm_heads
            per_token += 8.0 * cfg.xlstm_heads * dh * dh
        elif k == "slstm":
            dh = cfg.d_model // cfg.xlstm_heads
            per_token += 8.0 * cfg.xlstm_heads * dh * dh + 20.0 * cfg.d_model
    total = per_token * batch * seq
    if kind == "train":
        total *= 4.0
    return total / chips


def untraced_scan_flops(cfg, batch: int, seq: int, kind: str, chips: int, *,
                        remat: bool = True) -> float:
    """The part of :func:`inner_scan_correction` the trace's formulas do not
    count (they count products, not elementwise chains): Mamba's 6 of 8
    (y = hC is a product), the sequential mLSTM's 6 of 8 (Cᵀq is a product;
    the chunked form's outer products and Cq are einsums, all counted), the
    sLSTM's 20·d of gates (its recurrent matvecs are one product a step).
    Training × 4 with remat (forward, recomputation, backward ≈ 2), else × 3."""
    if kind == "decode":
        return 0.0
    per_token = 0.0
    for k in cfg.block_kinds():
        if k.startswith("mamba"):
            per_token += 6.0 * cfg.d_inner * cfg.ssm_state
        elif k == "mlstm" and not _chunked(cfg, seq):
            dh = 2 * cfg.d_model // cfg.xlstm_heads
            per_token += 6.0 * cfg.xlstm_heads * dh * dh
        elif k == "slstm":
            per_token += 20.0 * cfg.d_model
    total = per_token * batch * seq
    if kind == "train":
        total *= 4.0 if remat else 3.0
    return total / chips


def _axis_names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _local_shape(shape, spec, sizes: Mapping[str, int]) -> tuple[int, ...]:
    """One device's shard of ``shape`` under ``spec`` (the spec functions
    shard only dimensions the axes divide)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // math.prod(sizes[a] for a in _axis_names(e)) for n, e in zip(shape, spec))


def _local_bytes(tensors: Mapping[str, Any], specs: Mapping[str, Any], sizes) -> int:
    return sum(math.prod(_local_shape(tuple(t.shape), specs[k], sizes)) * t.element_size()
               for k, t in tensors.items())


def _names_model(spec, model_axis: str) -> bool:
    return any(model_axis in _axis_names(e) for e in spec)


def collectives(cfg, kind: str, rules: ShardingRules, *, params: Mapping[str, Any],
                p_specs: Mapping[str, Any], batch: int, seq: int, zero: bool = False,
                zero3: bool = False, remat: bool = True, accum: int = 1) -> dict:
    """Per-device collectives of one step, ``{op: {"count", "bytes"}}``, by
    the module docstring's rules: ``batch`` is one device's batch, ``seq``
    the tokens a sequence (1 for a decode step)."""
    sizes = rules.axis_sizes
    hist: dict[str, dict] = {}

    def add(op: str, count: float, nbytes: float) -> None:
        h = hist.setdefault(op, {"count": 0.0, "bytes": 0.0})
        h["count"] += count
        h["bytes"] += nbytes

    passes = (3 if remat else 2) if kind == "train" else 1
    if kind == "train" and rules.data_size > 1:
        by_dtype: dict[torch.dtype, int] = collections.Counter()
        for k, t in params.items():
            by_dtype[t.dtype] += math.prod(_local_shape(tuple(t.shape), p_specs[k], sizes)) \
                * t.element_size()
        if zero or zero3:
            gathers = passes if zero3 else 1
            for n in by_dtype.values():
                add("reduce-scatter", 1, n)
                add("all-gather", gathers, gathers * n)
        else:
            by_dtype[torch.float32] += 4  # the loss joins the f32 buffer
            for n in by_dtype.values():
                add("all-reduce", 1, 2.0 * n)
    model_axis = rules.model_axis
    if rules.model_size > 1 and model_axis not in rules.data_axes:
        act = batch * seq * cfg.d_model * dtype_of(cfg).itemsize
        calls = passes * accum
        tokens = batch * seq
        for i, block in enumerate(cfg.block_kinds()):
            add("all-reduce", calls, calls * 2.0 * act)  # the mixer's output
            if block in ("mamba", "mlstm", "slstm"):
                continue
            if block.endswith("_moe") and _names_model(p_specs[f"blocks.{i}.ffn.w_gate"][:1],
                                                        model_axis):
                g = min(cfg.moe_group_size, tokens)
                dispatched = (tokens // g) * cfg.n_experts * cfg.moe_split * capacity(cfg, g) \
                    * cfg.d_model * dtype_of(cfg).itemsize
                add("all-to-all", 2 * calls, 2 * calls * dispatched)
            else:
                add("all-reduce", calls, calls * 2.0 * act)  # the FFN's output
    return hist


# ---------------------------------------------------------------------------
# Cells.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """One cell, ready to trace: ``trace()`` traces its step and returns
    (:class:`Trace`, seconds); ``meta`` holds the record's cell fields, its
    exact argument bytes and its collectives; ``cfg`` the config traced."""

    trace: Any
    meta: dict
    cfg: Any


def _mesh_label(sizes: Mapping[str, int]) -> str:
    return "x".join(str(n) for n in sizes.values())


def build_cell(arch: str, shape: str | ShapeSpec, multi_pod: bool = False, *,
               mesh: Mapping[str, int] | None = None, zero: bool = False,
               zero3: bool = False, seq_shard: bool = True, accum: int = 1,
               remat: bool = True, attn_chunk: int = 0, score_dtype: str = "float32",
               replicate_below: int = 0, moe_group: int = 0, capacity_factor: float = 0.0,
               moe_gather: bool = False, dp_only: bool = False, moe_split: int = 0,
               xlstm_chunk: int = 0, cache_seq_shard: bool = False,
               config=None) -> Cell:
    """One cell. ``shape`` is a name in ``SHAPES`` or a ``ShapeSpec``;
    ``mesh`` an axis-size mapping (its axes but ``model`` the data axes) in
    place of the production mesh; ``config`` an ``ArchConfig`` in place of
    ``arch``'s published one (a smoke config). The knobs are the
    reference's; the port refuses ``attn_chunk`` and ``score_dtype`` away
    from their defaults (its attention is the flash kernel)."""
    cfg = get_config(arch) if config is None else config
    knobs = dict(attn_chunk=attn_chunk, score_dtype=score_dtype,
                 moe_group_size=moe_group, capacity_factor=capacity_factor,
                 moe_split=moe_split, xlstm_chunk=xlstm_chunk)
    defaults = dict(attn_chunk=0, score_dtype="float32", moe_group_size=0,
                    capacity_factor=0.0, moe_split=0, xlstm_chunk=0)
    cfg = dataclasses.replace(cfg, **{k: v for k, v in knobs.items() if v != defaults[k]})
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    if mesh is None:
        sizes = make_production_mesh(multi_pod=multi_pod)
        axes = data_axes(multi_pod)
    else:
        sizes = dict(mesh)
        axes = tuple(a for a in sizes if a != "model")
    if dp_only:
        # Both mesh axes act as data parallelism; every weight replicates.
        replicate_below, seq_shard = 1 << 62, False
        axes = axes + ("model",)
    rules = ShardingRules(mesh=sizes, data_axes=axes,
                          seq_shard=seq_shard and spec.kind == "train",
                          replicate_below=replicate_below, moe_gather_tokens=moe_gather,
                          cache_seq_shard=cache_seq_shard)
    model = Model(cfg, device="meta", remat=remat)
    params = dict(model.named_parameters())
    p_specs = param_pspecs(params, rules)
    if zero3 and spec.kind == "train":
        p_specs = zero_pspecs(p_specs, params, rules)
    batch = input_specs(cfg, spec)
    pos = batch.pop("pos", None)
    b_specs = batch_pspec(batch, rules)
    # One device's batch: the batch specs' share (a decode step's, that of
    # the cache, which shards alike).
    local_batch = {k: torch.empty(_local_shape(tuple(t.shape), b_specs[k], sizes),
                                  dtype=t.dtype, device="meta") for k, t in batch.items()}
    b_local = next(iter(local_batch.values())).shape[0]
    if pos is not None:
        b_specs = {k: () for k in batch}  # a decode step's tokens and pos arrive whole
    arg = {"params": _local_bytes(params, p_specs, sizes),
           "batch": _local_bytes(batch, b_specs, sizes) + (0 if pos is None else pos.nbytes)}
    split = 1 if rules.model_axis in rules.data_axes else rules.model_size
    counts = cfg.param_counts()
    meta = {
        "arch": arch, "shape": spec.name, "mesh": _mesh_label(sizes),
        "chips": math.prod(sizes.values()), "kind": spec.kind,
        "tokens_per_step": spec.batch * (spec.seq if spec.kind != "decode" else 1),
        "params_total": counts["total"], "params_active": counts["active"],
        "n_periods": cfg.n_periods, "batch": spec.batch, "seq": spec.seq,
        "batch_per_device": b_local, "model_split": split,
        "zero": zero, "zero3": zero3, "seq_shard": seq_shard, "accum": accum, "remat": remat,
        "attn_chunk": attn_chunk, "score_dtype": score_dtype,
        "replicate_below": replicate_below, "moe_group": moe_group or None,
        "capacity_factor": capacity_factor or None, "moe_gather": moe_gather,
        "dp_only": dp_only, "moe_split": moe_split or None, "xlstm_chunk": xlstm_chunk or None,
        "cache_seq_shard": cache_seq_shard,
    }
    step_seq = spec.seq if spec.kind != "decode" else 1
    coll_kw = dict(params=params, p_specs=p_specs, batch=b_local, seq=step_seq, zero=zero,
                   zero3=zero3, remat=remat, accum=accum)

    if spec.kind == "train":
        opt = AdamW(moment_dtype=_moment_dtype(cfg))
        opt_state = opt.init(params)
        m_specs = zero_pspecs(p_specs, params, rules) if (zero and not zero3) else p_specs
        arg["opt_state"] = (_local_bytes(opt_state.m, m_specs, sizes)
                            + _local_bytes(opt_state.v, m_specs, sizes)
                            + opt_state.step.element_size())
        meta["moment_dtype"] = opt.moment_dtype
        sched = functools.partial(warmup_cosine, peak_lr=3e-4, warmup_steps=100,
                                  total_steps=10000)
        step_fn = make_train_step(model, opt, sched, accum=accum)

        def run(trace):
            with _stand_ins(_plans(model, b_local // accum, spec.seq, True), trace):
                step_fn(opt_state, local_batch)
    elif spec.kind == "prefill":
        def run(trace):
            with _stand_ins(_plans(model, b_local, spec.seq, False), trace), \
                    torch.inference_mode():
                if cfg.encoder_only:
                    model.forward(local_batch)
                else:
                    model.prefill(local_batch, spec.seq)
    else:
        cache = model.init_cache(spec.batch, spec.seq)
        c_specs = cache_pspecs(cache, rules)
        arg["cache"] = sum(_local_bytes(entry, s, sizes) for entry, s in zip(cache, c_specs))
        del cache
        local_cache = model.init_cache(b_local, spec.seq)

        def run(trace):
            model.decode_step(local_cache, local_batch["tokens"], spec.seq - 1)

    meta["argument_bytes"] = arg
    meta["collectives"] = collectives(cfg, spec.kind, rules, **coll_kw)

    def trace_fn():
        trace = Trace()
        t0 = time.perf_counter()
        with ops.force_impl("kernel"), fa.counting_meta(trace), trace:
            run(trace)
        return trace, time.perf_counter() - t0

    return Cell(trace_fn, meta, cfg)


def _peaks(device: str):
    """The card's peak row, or the H100 SXM's data sheet on ``cpu``."""
    name = None if device == "cpu" else torch.cuda.get_device_name(0)
    hw = peaks_for(name)
    return hw, (f"{hw.name} (data sheet; --device cpu)" if name is None else hw.name)


def cell_record(cell: Cell, *, device: str = "cpu", tag: str | None = None,
                variant: str = "baseline") -> dict:
    """Trace one cell built by :func:`build_cell` and return its record."""
    meta, cfg = cell.meta, cell.cfg
    coll_hist = meta["collectives"]
    trace, seconds = cell.trace()
    split, chips = meta["model_split"], meta["chips"]
    flops_by_dtype = {k: v / split for k, v in trace.flops.items() if v}
    scan_fix = untraced_scan_flops(cfg, meta["batch"], meta["seq"], meta["kind"], chips,
                                   remat=meta["remat"])
    if scan_fix:
        flops_by_dtype["float32"] = flops_by_dtype.get("float32", 0.0) + scan_fix
    flops = float(sum(flops_by_dtype.values()))
    nbytes = trace.bytes / split
    coll_bytes = float(sum(h["bytes"] for h in coll_hist.values()))
    hw, peaks_name = _peaks(device)
    # Each dtype's products at its own peak.
    rt = roofline_terms(flops_by_dtype.get("bfloat16", 0.0), nbytes, dtype=torch.bfloat16,
                        hw=hw, collective_bytes=coll_bytes)
    rt = dataclasses.replace(rt, flops=flops, compute_s=rt.compute_s + flops_by_dtype.get(
        "float32", 0.0) / hw.peak_flops(torch.float32))
    mf = model_flops(meta["params_total"], meta["tokens_per_step"],
                     active_params=meta["params_active"])
    if meta["kind"] != "train":
        mf /= 3.0
    arg = meta["argument_bytes"]
    record = {
        "tag": tag, "variant": variant, **meta,
        "compile_ok": True,
        "analysis": "meta-trace",
        "lower_s": round(seconds, 2),
        "compile_s": 0.0,
        "trace_s": seconds,
        "device": device,
        "peaks": peaks_name,
        "memory": {"argument_size_in_bytes": float(sum(arg.values())),
                   "temp_size_in_bytes": float(trace.peak)},
        "temp_bound": "model axis undivided" if split > 1 else None,
        "cost": {"flops": flops, "bytes accessed": nbytes},
        "flops_by_dtype": flops_by_dtype,
        "inner_scan_correction_flops": scan_fix,
        "inner_scan_closed_form_flops": inner_scan_correction(
            cfg, meta["batch"], meta["seq"], meta["kind"], chips),
        "kernel_entries": dict(trace.entries),
        "roofline": {
            "flops_per_device": rt.flops,
            "hbm_bytes_per_device": rt.hbm_bytes,
            "collective_bytes_per_device": rt.collective_bytes,
            "compute_s": rt.compute_s,
            "memory_s": rt.memory_s,
            "collective_s": rt.collective_s,
            "dominant": rt.dominant,
            "roofline_fraction": rt.roofline_fraction,
            "bound_s": rt.bound_s,
            "arithmetic_intensity": rt.arithmetic_intensity(),
        },
        "model_flops": mf,
        "useful_compute_ratio": mf / (flops * chips) if flops else 0.0,
    }
    return record


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str, *, force: bool = False,
             variant: str = "baseline", device: str = "cpu", **opts) -> dict:
    tag = f"{arch}__{shape}__{'multi' if multi_pod else 'single'}__{variant}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    ok, reason = applicability(get_config(arch), shape)
    mesh = _mesh_label(make_production_mesh(multi_pod=multi_pod))
    if not ok:
        rec = {"tag": tag, "skip": reason, "arch": arch, "shape": shape, "mesh": mesh,
               "variant": variant}
        _write(path, rec)
        print(f"[dryrun] SKIP {tag}: {reason}", flush=True)
        return rec
    rec = cell_record(build_cell(arch, shape, multi_pod, **opts), device=device, tag=tag,
                      variant=variant)
    _write(path, rec)
    mem = rec["memory"]
    print(f"[dryrun] OK {tag}: trace {rec['trace_s']:.2f}s, mem/device ≈ "
          f"{sum(mem.values()) / 2**30:.2f} GiB (args {mem['argument_size_in_bytes'] / 2**30:.2f}"
          f" + temp {mem['temp_size_in_bytes'] / 2**30:.2f}"
          f"{', an upper bound' if rec['temp_bound'] else ''}), "
          f"dominant={rec['roofline']['dominant']} "
          f"fraction={rec['roofline']['roofline_fraction']:.3f}; kernel entries "
          f"{rec['kernel_entries'] or 'none'}", flush=True)
    r = rec["roofline"]
    print("  cost: flops=%.3e bytes=%.3e coll=%.3e (%s)" % (
        r["flops_per_device"], r["hbm_bytes_per_device"], r["collective_bytes_per_device"],
        rec["peaks"]), flush=True)
    return rec


def _write(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCHS, default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--zero", action="store_true")
    ap.add_argument("--zero3", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--attn-chunk", type=int, default=0)
    ap.add_argument("--score-dtype", default="float32")
    ap.add_argument("--replicate-below", type=int, default=0)
    ap.add_argument("--moe-group", type=int, default=0)
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--moe-gather", action="store_true")
    ap.add_argument("--dp-only", action="store_true")
    ap.add_argument("--moe-split", type=int, default=0)
    ap.add_argument("--xlstm-chunk", type=int, default=0)
    ap.add_argument("--cache-seq-shard", action="store_true")
    ap.add_argument("--out", default=os.path.normpath(ARTIFACT_DIR))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="whose peaks the roofline takes: the card's (default), or the "
                         "H100 SXM's data sheet on cpu; the trace is on meta either way")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (ask for --device cpu to hold the "
              "cells against the H100 SXM's data-sheet peaks)", file=sys.stderr)
        return 2

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    t0 = time.perf_counter()
    failures = []
    for arch, shape in cells:
        for multi in meshes:
            try:
                run_cell(
                    arch, shape, multi, args.out, force=args.force, variant=args.variant,
                    device=args.device, zero=args.zero, zero3=args.zero3,
                    seq_shard=not args.no_seq_shard, accum=args.accum,
                    remat=not args.no_remat, attn_chunk=args.attn_chunk,
                    score_dtype=args.score_dtype, replicate_below=args.replicate_below,
                    moe_group=args.moe_group, capacity_factor=args.capacity_factor,
                    moe_gather=args.moe_gather, dp_only=args.dp_only,
                    moe_split=args.moe_split, xlstm_chunk=args.xlstm_chunk,
                    cache_seq_shard=args.cache_seq_shard,
                )
            except Exception as e:  # noqa: BLE001 — report, keep tracing cells
                failures.append((arch, shape, multi, repr(e)))
                print(f"[dryrun] FAIL {arch}/{shape}/multi={multi}: {e!r}", flush=True)
    wall = time.perf_counter() - t0
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES ({wall:.1f} s)", flush=True)
        return 1
    print(f"[dryrun] all requested cells passed ({wall:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
