"""Public entry points of the kernel layer.

Counterpart of ``repro/kernels/ops.py``. Each op dispatches between its
hand-written kernel and its plain PyTorch oracle (``kernels/ref.py``):

- ``mode="kernel"`` takes the kernel route: CUDA tensors launch the CUDA
  kernel (or raise), CPU tensors run the plain version, which is how the
  reference runs a Pallas kernel interpreted off-TPU; meta tensors on
  ``attention`` take its meta route, which launches nothing and returns
  the kernel's output shape while it adds the kernel's analytic cost to the
  dry run's counter (``flash_attention.counting_meta``);
- ``mode="ref"`` runs the oracle;
- ``mode="auto"`` picks by the tensor's device: the kernel for a CUDA
  tensor, the oracle for a CPU tensor.

``force_impl(mode, op, **params)`` sets a context-local override consulted
by every call made with ``mode="auto"`` (an explicit ``mode=`` always wins);
``params`` merge under the call site's block sizes for the named op only.
The reference enters it around tracing, because JAX bakes the choice into
the compiled program. PyTorch runs eagerly, so here the choice is made on
every call, and the engine enters the context around every call it makes.

``KERNEL_OPS`` names the ops that have a kernel, each mapped to its module
(whose ``tune_space()`` the tune stage sweeps). Only ops with a kernel are
listed, so nothing can ask for a kernel that does not exist.

:class:`TileRefused` is what a kernel raises, before any launch, for block
parameters it has no compiled tile for: the tune stage skips such a
candidate and counts it, where any other error fails the row.

**Batching rules.** Under ``torch.vmap`` (the serve stage's width-w calls,
``core.features.concurrent_instances``) a kernel route meets a
BatchedTensor, whose data pointer the C entries cannot take. The
reference's ``jax.vmap`` of a ``pallas_call`` adds a grid axis through
Pallas's batching rule; here each op has a rule of its own, reached
through one ``torch.autograd.Function`` with a ``vmap`` staticmethod
(:class:`_KernelOp`, ``generate_vmap_rule = False``). The rule receives the
physical tensors with their batch dims and launches the same hand-written
kernels on them: it is no fallback, and a CUDA tensor under it launches a
kernel or raises. Folding rules put the batch into one launch of an
existing entry:

- ``matmul``: (w, M, K) @ (K, N) or (w, K, N), and a broadcast (M, K) @
  (w, K, N), as one batched product (the f32 TMA kernel's 3-D tensor maps,
  the bf16 kernel's batch axis); a batched (B, M, K) operand folds w into
  B. Other rank pairs run one product a member.
- ``softmax``: (w, R, C) as (w·R, C) rows; ``lrn`` and ``avgpool``:
  (w, N, C, H, W) as (w·N, C, H, W); ``attention``: w folded into B (an
  unbatched k or v is expanded to w, a copy).

``prefix_scan``, ``sort_kv`` and ``srad_step`` have no batch axis in their
kernels: their rule launches the kernel once a member, each launch counted
under its entry (ROADMAP queue 2 holds their batched entries). Only a
batched call takes a rule (:func:`is_batched`), so an unbatched call keeps
its direct path, with no dispatcher cost on the measured rows; on CPU
tensors the rule runs over the plain versions, which is how the tests here
reach it.

**Sharding rules.** A DTensor operand (a placement over a ``DeviceMesh``,
``runtime/sharding.py``) has no data pointer a C entry can take either.
Each op has a sharding rule next to its batching rule (:func:`sharded`,
with the op's :data:`_LOCAL` predicate), and takes it whenever an operand
is a DTensor, under either route:

- **local**: where the op is independent along every sharded dimension,
  the op runs on each rank's local shard and its output keeps the shard
  (``matmul`` with ``a`` sharded on any dims but the contracted one and
  ``b`` replicated, the batched product with both on the batch axis;
  ``softmax`` on any dims but the last; ``lrn`` on any but the channels;
  ``avgpool`` on batch or channels; ``attention`` with q, k and v sharded
  alike on the batch and the heads, the head rule: each rank's query heads
  over its own KV heads; any op whose operands are all replicated);
- **split** (``attention`` only): k and v sharded alike on the keys (dim
  2, a cache split on its sequence, ``ShardingRules.cache_seq_shard``)
  over some mesh dims, and perhaps on the batch and the heads, not on D;
  no window, and causal only for one query a row (a decode step). q, in
  any layout, is laid out on k's batch and head shards and replicated
  elsewhere (an activation's redistribution; a ``Partial`` one reduced).
  Each rank attends over its own slots below ``kv_len``, ``clamp(kv_len -
  offset, 0, S_local)`` of them (offset: its first slot,
  :func:`shard_offset`), through the routed entry with
  ``return_lse=True``; a rank
  with no valid slot launches nothing and contributes ``o = 0``, ``lse =
  -inf``. :func:`merge_key_splits` then merges the ranks with one
  all-reduce MAX of the lse and one all-reduce SUM of ``[w·o | w]`` in f32
  (``w = exp(lse - max)``) over the split's mesh dims, ``o = Σw·o / Σw``
  cast to q's dtype: flash-decoding's combine across ranks, the port's
  counterpart of what GSPMD compiles from the reference's sequence-sharded
  cache. No rank gathers the cache. The output is replicated over the
  split's mesh dims and keeps k's batch and head shards. On one rank w = 1
  and the merge divides by 1: the output is the entry's, bit for bit;
- **gathered**: otherwise the operands are redistributed to ``Replicate``
  first (a ``Partial`` one reduced) on every dim the op cannot take
  sharded, and the op runs on every rank, as XLA runs a custom call it
  cannot partition. ``prefix_scan``, ``sort_kv`` and ``srad_step`` gather
  whatever is sharded, their output replicated; ``attention`` keeps the
  batch and head shards q, k and v share (its output keeps them) and
  gathers the rest: a cache split on head_dim gathers K and V over the
  mesh dims of D alone, never the batch.

Either way the op's own route runs on plain tensors: a CUDA DTensor
launches the kernel (counted under its entry) or raises, a CPU one runs
the plain versions. :data:`dtensor_rules` counts each (op, rule) taken
(``local``, ``split``, ``gathered``).
A layout (:func:`shard_dims`) names, per tensor dim, the mesh dims that
shard it, so a rule holds on a mesh of any rank (the model's ``(pod,
data, model)`` mesh: the batch over ``pod`` and ``data``, the heads over
``model``), and the output gets one placement a mesh dim.
Workload functions that DTensor's own propagation cannot run (a tensor
made inside from a shape, a host-checked loop) declare a rule through the
same decorator (``bench/dnn/dropout.py``, ``bench/level2/mandelbrot.py``).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import math
from typing import Callable, Literal

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import avgpool as _avgpool_mod
from repro_torch.kernels import bitonic_sort as _sort_mod
from repro_torch.kernels import flash_attention as _attention_mod
from repro_torch.kernels import lrn as _lrn_mod
from repro_torch.kernels import matmul as _matmul_mod
from repro_torch.kernels import prefix_scan as _scan_mod
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import softmax as _softmax_mod
from repro_torch.kernels import srad_stencil as _srad_mod

__all__ = [
    "matmul", "attention", "softmax", "lrn", "avgpool", "srad_step", "prefix_scan", "sort_kv",
    "force_impl", "reenter_impl", "takes_kernel", "tune_space", "is_batched", "KERNEL_OPS",
    "MODES",
    "TileRefused",
    "sharded",
    "shard_dims",
    "dtensor_rules",
    "merge_key_splits",
    "shard_offset",
]

Mode = Literal["auto", "kernel", "ref"]


class TileRefused(ValueError):
    """Block parameters naming a tile the routed entry does not compile,
    raised before anything is launched."""

MODES = ("auto", "kernel", "ref")

# op name -> kernel module exporting tune_space(). A Workload's ``kernel``
# field names one of these keys (registry.py impl contract).
KERNEL_OPS = {
    "matmul": _matmul_mod,
    "attention": _attention_mod,
    "softmax": _softmax_mod,
    "lrn": _lrn_mod,
    "avgpool": _avgpool_mod,
    "srad_step": _srad_mod,
    "prefix_scan": _scan_mod,
    "sort_kv": _sort_mod,
}

# (mode, op-or-None, params) set by force_impl; consulted only for
# mode="auto" call sites so an explicit mode= keeps absolute priority.
_FORCED: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_forced_impl", default=None
)


@contextlib.contextmanager
def force_impl(mode: Mode, op: str | None = None, **params):
    """Context-locally override ``mode="auto"`` dispatch for the kernel ops.

    The mode applies to every op; ``params`` (block sizes) are merged into
    every op's calls when ``op`` is None, else only into calls of the named
    op. Dispatch happens on each call,
    so the context must be active around every call it should govern.
    """
    if mode not in MODES:
        raise ValueError(f"force_impl mode must be one of {MODES}, got {mode!r}")
    token = _FORCED.set((mode, op, dict(params)))
    try:
        yield
    finally:
        _FORCED.reset(token)


def reenter_impl():
    """A context manager that sets the :func:`force_impl` state active at
    this call again, for work that runs later on another thread: autograd
    runs a CUDA backward (a checkpointed block's recomputation with it) on
    a thread of its own, which the context variable does not reach."""
    state = _FORCED.get()

    @contextlib.contextmanager
    def again():
        token = _FORCED.set(state)
        try:
            yield
        finally:
            _FORCED.reset(token)

    return again()


def _resolve(op: str, mode: Mode, x: torch.Tensor, blocks: dict) -> tuple[bool, dict]:
    """-> (take the kernel route, block params), after any force_impl."""
    forced = _FORCED.get()
    if mode == "auto" and forced is not None:
        mode, f_op, f_params = forced
        if f_params and (f_op is None or f_op == op):
            blocks = {**f_params, **blocks}
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "auto":
        return x.is_cuda, blocks
    return mode == "kernel", blocks


def takes_kernel(op: str, x: torch.Tensor, mode: Mode = "auto") -> bool:
    """Whether a call of ``op`` on ``x`` with ``mode`` takes the kernel
    route under the active :func:`force_impl` (what a cached capture of the
    call depends on)."""
    return _resolve(op, mode, x, {})[0]


def tune_space(op: str) -> tuple[dict, ...]:
    """The autotune candidates for ``op`` (first entry = kernel defaults)."""
    try:
        module = KERNEL_OPS[op]
    except KeyError:
        raise KeyError(f"unknown kernel op {op!r}; known: {sorted(KERNEL_OPS)}") from None
    return module.tune_space()


# -- sharding rules -----------------------------------------------------------

# (op, "local", "split" or "gathered") -> calls that took that rule.
dtensor_rules: collections.Counter = collections.Counter()

Layout = dict  # tensor dim -> the mesh dims that shard it, in mesh order


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def _has_dtensor(args) -> bool:
    # A plain tensor (the measured rows' case) costs one type check.
    return any(isinstance(a, torch.Tensor) and type(a) is not torch.Tensor
               and isinstance(a, _dtensor_type()) for a in args)


def shard_dims(t) -> Layout | None:
    """Per tensor dim of ``t``, the mesh dims that shard it (``{}``: not a
    DTensor, or replicated on every mesh dim), on a mesh of any rank; None
    for a layout no rule keeps local: a ``Partial``, a strided shard, a
    dim the mesh dims naming it do not divide evenly."""
    from torch.distributed.tensor import Shard

    if not isinstance(t, _dtensor_type()):
        return {}
    out: Layout = {}
    for i, p in enumerate(t.placements):
        if p.is_replicate():
            continue
        if type(p) is not Shard:  # Partial, _StridedShard
            return None
        out.setdefault(p.dim % t.dim(), []).append(i)
    mesh = t.device_mesh
    for d, dims in out.items():
        if t.shape[d] % math.prod(mesh.size(i) for i in dims):
            return None
    return {d: tuple(dims) for d, dims in out.items()}


def _placements(layout: Layout, ndim: int) -> tuple:
    """One placement a mesh dim: ``Shard(d)`` where ``layout`` names the
    mesh dim for tensor dim ``d``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    by_mesh_dim = {i: d for d, dims in layout.items() for i in dims}
    return tuple(Shard(by_mesh_dim[i]) if i in by_mesh_dim else Replicate()
                 for i in range(ndim))


def sharded(name: str, local: Callable[..., Layout | None], *,
            split: Callable | None = None, keep: Callable[..., Layout] | None = None):
    """Decorate ``fn`` (its tensor operands positional) with a sharding
    rule: a call with a DTensor operand runs ``fn`` on each rank's local
    shards when ``local(*operands, **kwargs)`` returns the output's layout
    (a :func:`shard_dims` dict; every operand replicated needs no rule);
    else ``split(fn, *operands, **kwargs)``, where given, runs the call its
    own way and returns its output, or None where it does not apply; else
    ``fn`` runs on the operands gathered: to ``Replicate`` on every mesh dim
    but those of ``keep(*operands, **kwargs)``'s layout (every operand holds
    it alike; the output keeps it), to ``Replicate`` everywhere without
    ``keep``. Plain calls go straight to ``fn``. The output's placements
    have one entry a mesh dim."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _has_dtensor(args):
                return fn(*args, **kwargs)
            dtensor = _dtensor_type()
            mesh = next(a.device_mesh for a in args if isinstance(a, dtensor))
            if all(shard_dims(a) == {} for a in args):
                out_layout = {}
            else:
                out_layout = local(*args, **kwargs)
            if out_layout is None and split is not None:
                out = split(fn, *args, **kwargs)
                if out is not None:
                    _build.count(dtensor_rules, (name, "split"))
                    return out
            rule = "gathered" if out_layout is None else "local"
            if rule == "gathered":
                out_layout = keep(*args, **kwargs) if keep is not None else {}
            out_pl = _placements(out_layout, mesh.ndim)
            _build.count(dtensor_rules, (name, rule))
            plain = tuple(
                a if not isinstance(a, dtensor)
                else a.to_local() if rule == "local"
                else a.redistribute(mesh, out_pl).to_local()
                for a in args
            )
            out = fn(*plain, **kwargs)

            def back(t):
                return dtensor.from_local(t, mesh, out_pl, run_check=False)

            return tuple(back(t) for t in out) if isinstance(out, tuple) else back(out)

        return call

    return wrap


def _free_of(layout: Layout | None, *dims: int) -> bool:
    """A layout that shards none of ``dims``."""
    return layout is not None and not any(d in layout for d in dims)


def _matmul_local(a, b, **_):
    """Rows (any dims of ``a`` but the contracted one) against a replicated
    2-D ``b``; a replicated 2-D ``a`` against ``b``'s columns; a batched
    ``b`` on its batch axis against a replicated 2-D ``a`` (a weight
    broadcast over images) or an ``a`` sharded alike."""
    la, lb = shard_dims(a), shard_dims(b)
    if la is None or lb is None:
        return None
    if b.dim() == 2 and lb == {} and _free_of(la, a.dim() - 1):
        return la
    if a.dim() == 2 == b.dim() and la == {} and set(lb) == {1}:
        return lb
    if b.dim() == 3 and set(lb) == {0} and (a.dim() == 2 and la == {}
                                           or a.dim() == 3 and la == lb):
        return lb
    return None


def _attention_local(q, k, v, **_):
    """q (B, Hq, T, D), k and v (B, Hkv, S, D), sharded alike on the batch
    (dim 0) and on the heads (dim 1), nowhere else: each rank's query heads
    then attend to its own KV heads (the group Hq / Hkv maps a rank's query
    heads into its KV heads because the mesh dims divide Hkv evenly).
    Heads sharded on q alone, a KV head split, or any shard of T, S or D
    does not stay local (a shard of S alone may take the split rule)."""
    lq, lk, lv = shard_dims(q), shard_dims(k), shard_dims(v)
    if not (lq == lk == lv and _free_of(lq, 2, 3)):
        return None
    return lq


def _attention_keep(q, k, v, **_):
    """The gathered rule's kept layout: the batch and head shards that q, k
    and v share (the head rule's, on dims 0 and 1); D, S and T are
    gathered."""
    lq, lk, lv = shard_dims(q), shard_dims(k), shard_dims(v)
    if lq is None or lk is None or lv is None:
        return {}
    return {d: lq[d] for d in (0, 1) if d in lq and lq[d] == lk.get(d) == lv.get(d)}


def merge_key_splits(out: torch.Tensor, lse: torch.Tensor, reduce) -> torch.Tensor:
    """Attention over slices of the keys merged into attention over all of
    them: ``out`` (..., D) a slice's output and ``lse`` (...) its rows'
    log-sum-exp (-inf where the slice holds no visible key, its ``out`` 0);
    ``reduce(x, op)`` with op ``"max"`` or ``"sum"`` returns ``x`` reduced
    over the slices (an all-reduce over the ranks that hold them, or a
    reduction over a leading axis that stacks them, broadcastable against
    ``x``). m = max lse; w = exp(lse - m) (0 for a slice of -inf, and for
    every slice of a row no slice sees); then ``[w·o | w]`` in f32 reduced
    by one sum; o = Σw·o / Σw (0 where Σw = 0) in ``out``'s dtype. One
    slice: w = 1 and a division by 1, its ``out`` bit for bit."""
    m = reduce(lse.float(), "max")
    w = torch.exp(lse.float() - torch.where(torch.isfinite(m), m, 0.0))
    both = reduce(torch.cat([out.float() * w[..., None], w[..., None]], dim=-1), "sum")
    num, den = both[..., :-1], both[..., -1:]
    return (num / torch.where(den > 0, den, 1.0)).to(out.dtype)


def shard_offset(mesh, mesh_dims: tuple, size: int) -> int:
    """This rank's first index along a tensor dim that ``mesh_dims`` (in
    mesh order, as :func:`shard_dims` names them) shard evenly into
    ``size`` local entries."""
    coord = mesh.get_coordinate()
    index = 0
    for i in mesh_dims:
        index = index * mesh.size(i) + coord[i]
    return index * size


def _attention_split(fn, q, k, v, *, causal=False, window=None, kv_len=None,
                     return_lse=False, **kwargs):
    """The split rule (the module docstring's), or None where it does not
    apply."""
    lk, lv = shard_dims(k), shard_dims(v)
    if (return_lse or window is not None or (causal and q.shape[2] != 1) or lk is None
            or lk != lv or 2 not in lk or 3 in lk):
        return None
    from torch.distributed._functional_collectives import all_reduce

    mesh = k.device_mesh
    seq = lk[2]
    q_pl = _placements({d: lk[d] for d in (0, 1) if d in lk}, mesh.ndim)
    ql = q.redistribute(mesh, q_pl).to_local() if isinstance(q, _dtensor_type()) else q
    kl, vl = k.to_local(), v.to_local()
    s_local = kl.shape[2]
    total = k.shape[2] if kv_len is None else min(kv_len, k.shape[2])
    valid = max(0, min(total - shard_offset(mesh, seq, s_local), s_local))
    if valid:
        out, lse = fn(ql, kl[:, :, :valid], vl[:, :, :valid], causal=causal,
                      return_lse=True, **kwargs)
    else:  # no slot of this rank is below kv_len: nothing to attend to
        out = ql.new_zeros(ql.shape)
        lse = torch.full(ql.shape[:3], float("-inf"), device=ql.device)

    def reduce(x, op):
        for i in seq:
            x = all_reduce(x, op, (mesh, i))
        return x

    merged = merge_key_splits(out, lse, reduce)
    return _dtensor_type().from_local(merged, mesh, q_pl, run_check=False)


def _softmax_local(x, **_):
    lx = shard_dims(x)
    return lx if _free_of(lx, x.dim() - 1) else None


def _lrn_local(x, **_):
    lx = shard_dims(x)  # the window runs along the channels (dim 1)
    return lx if _free_of(lx, 1) else None


def _avgpool_local(x, **_):
    lx = shard_dims(x)  # windows tile H and W
    return lx if _free_of(lx, 2, 3) else None


def _gathered(*_, **__):
    """A scan, a sort or a stencil step with a global reduction: no
    sharded dim is independent."""
    return None


@sharded("matmul", _matmul_local)
def matmul(a: torch.Tensor, b: torch.Tensor, *, mode: Mode = "auto", **blocks):
    """(M, K) or (B, M, K) @ (K, N) or (B, K, N), batches broadcast as in
    ``torch.matmul``."""
    use, blocks = _resolve("matmul", mode, a, blocks)
    if use:
        if is_batched(a) or is_batched(b):
            return _KernelOp.apply("matmul", _frozen(blocks), a, b)
        return _matmul_mod.matmul_kernel(a, b, **blocks)
    return _ref.matmul_ref(a, b)


@sharded("attention", _attention_local, split=_attention_split, keep=_attention_keep)
def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    kv_len: int | None = None,
    return_lse: bool = False,
    mode: Mode = "auto",
    **blocks,
):
    """GQA attention of q (B, Hq, T, D) over k, v (B, Hkv, S, D), the
    queries at the last T of the S key positions; with ``kv_len``, over the
    first ``kv_len`` slots only (the keys past it unseen, the queries at the
    last T of those ``kv_len``: the reference's ``sdpa(..., kv_len=)`` on a
    partly filled cache), on plain tensors the view ``[:, :, :kv_len]``.
    ``return_lse`` -> (out, lse (B, Hq, T) f32), each row's log-sum-exp
    (the split rule's partials; no batching or autograd rule takes it).

    On the kernel route, a call that autograd records (grad mode on, q, k
    or v requiring grad) goes through ``FlashAttentionFunction``: the
    kernel forward, the torch backward. Other calls keep the direct path."""
    if kv_len is not None:
        k, v = k[:, :, :kv_len], v[:, :, :kv_len]
    use, blocks = _resolve("attention", mode, q, blocks)
    if use:
        batched = any(is_batched(t) for t in (q, k, v))
        grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                            or v.requires_grad)
        if return_lse and (batched or grad):
            raise ValueError("attention's return_lse takes no batching or autograd rule")
        if batched:
            params = _frozen(dict(blocks, causal=causal, window=window, scale=scale))
            return _KernelOp.apply("attention", params, q, k, v)
        if grad:
            return _attention_mod.FlashAttentionFunction.apply(
                q, k, v, causal, window, scale, _frozen(blocks))
        return _attention_mod.flash_attention_kernel(
            q, k, v, causal=causal, window=window, scale=scale, return_lse=return_lse,
            **blocks
        )
    return _ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                              return_lse=return_lse)


@sharded("softmax", _softmax_local)
def softmax(x: torch.Tensor, *, mode: Mode = "auto"):
    use, _ = _resolve("softmax", mode, x, {})  # no block parameters
    if use:
        if is_batched(x):
            return _KernelOp.apply("softmax", (), x)
        return _softmax_mod.softmax_kernel(x)
    return _ref.softmax_ref(x)


@sharded("lrn", _lrn_local)
def lrn(x: torch.Tensor, *, size=5, alpha=1e-4, beta=0.75, k=2.0, mode: Mode = "auto"):
    use, _ = _resolve("lrn", mode, x, {})  # no block parameters
    if use:
        if is_batched(x):
            params = _frozen(dict(size=size, alpha=alpha, beta=beta, k=k))
            return _KernelOp.apply("lrn", params, x)
        return _lrn_mod.lrn_kernel(x, size=size, alpha=alpha, beta=beta, k=k)
    return _ref.lrn_ref(x, size=size, alpha=alpha, beta=beta, k=k)


@sharded("avgpool", _avgpool_local)
def avgpool(x: torch.Tensor, *, ksize=2, mode: Mode = "auto"):
    use, _ = _resolve("avgpool", mode, x, {})  # no block parameters
    if use:
        if is_batched(x):
            return _KernelOp.apply("avgpool", _frozen(dict(ksize=ksize)), x)
        return _avgpool_mod.avgpool_kernel(x, ksize=ksize)
    return _ref.avgpool_ref(x, ksize=ksize)


@sharded("srad_step", _gathered)
def srad_step(img: torch.Tensor, *, lam=0.5, q0sqr=0.05, fused: bool = True,
              mode: Mode = "auto"):
    """One SRAD step: the cooperative fused kernel, or its two phases."""
    use, _ = _resolve("srad_step", mode, img, {})  # no block parameters
    if use:
        if is_batched(img):
            params = _frozen(dict(lam=lam, q0sqr=q0sqr, fused=fused))
            return _KernelOp.apply("srad_step", params, img)
        return _srad_mod.srad_step_kernel(img, lam=lam, q0sqr=q0sqr, fused=fused)
    return _ref.srad_step_ref(img, lam=lam, q0sqr=q0sqr)


@sharded("prefix_scan", _gathered)
def prefix_scan(x: torch.Tensor, *, mode: Mode = "auto", **blocks):
    use, blocks = _resolve("prefix_scan", mode, x, blocks)
    if use:
        if is_batched(x):
            return _KernelOp.apply("prefix_scan", _frozen(blocks), x)
        return _scan_mod.prefix_scan_kernel(x, **blocks)
    return _ref.prefix_scan_ref(x)


@sharded("sort_kv", _gathered)
def sort_kv(keys: torch.Tensor, values: torch.Tensor, *, mode: Mode = "auto"):
    """Ascending key sort carrying values. The kernel route needs no padding
    (the reference pads to a power of two for its bitonic network)."""
    use, _ = _resolve("sort_kv", mode, keys, {})  # no block parameters
    if use:
        if is_batched(keys) or is_batched(values):
            return _KernelOp.apply("sort_kv", (), keys, values)
        return _sort_mod.sort_kv_kernel(keys, values)
    return _ref.sort_kv_ref(keys, values)


# -- batching rules -----------------------------------------------------------


def is_batched(t) -> bool:
    """Whether ``t`` is a tensor that ``torch.vmap`` is batching (a
    BatchedTensor, which has no storage of its own)."""
    return isinstance(t, torch.Tensor) and torch._C._functorch.is_batchedtensor(t)


def _frozen(params: dict) -> tuple:
    """Keyword parameters as a tuple of pairs: a leaf structure the vmap
    machinery passes through untouched."""
    return tuple(sorted(params.items()))


def _first(x: torch.Tensor, dim: int | None, w: int) -> torch.Tensor:
    """``x`` with its batch dim first, dense (a no-op for a stacked input);
    an unbatched operand expanded to ``w`` members."""
    if dim is None:
        return x.expand(w, *x.shape)
    return x.movedim(dim, 0).contiguous()


def _member(x: torch.Tensor, dim: int | None, j: int) -> torch.Tensor:
    return x if dim is None else x.select(dim, j)


def _per_member(w: int, dims: tuple, fn, *operands):
    """``fn`` once a member, the results stacked on a new leading axis: the
    rule of an op whose kernel has no batch axis (one launch a member)."""
    outs = [fn(*(_member(x, d, j) for x, d in zip(operands, dims))) for j in range(w)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs)), (0,) * len(outs[0])
    return torch.stack(outs), 0


def _matmul_rule(w, dims, params, a, b):
    """One batched product where the ranks allow it (see the module
    docstring), else one product a member."""
    blocks = dict(params)
    ad, bd = dims
    ra, rb = a.dim() - (ad is not None), b.dim() - (bd is not None)
    if ra == 2 and rb == 2:
        # (w, M, K) @ (K, N) / (M, K) @ (w, K, N) / (w, M, K) @ (w, K, N).
        a1 = a if ad is None else a.movedim(ad, 0)
        b1 = b if bd is None else b.movedim(bd, 0)
        return matmul(a1, b1, mode="kernel", **blocks), 0
    if ra == 3 and ad is not None and rb in (2, 3):
        # Members of (B, M, K) products: w folds into B, a shared (K, N)
        # broadcast, a batched (B, K, N) folded alike.
        a1 = _first(a, ad, w)
        n_b = a1.shape[1]
        b1 = b if bd is None else _first(b, bd, w)
        if rb == 2 and bd is None or rb == 3 and bd is not None and b1.shape[1] == n_b:
            out = matmul(a1.flatten(0, 1), b1 if bd is None else b1.flatten(0, 1),
                         mode="kernel", **blocks)
            return out.unflatten(0, (w, n_b)), 0
    return _per_member(w, dims, lambda x, y: matmul(x, y, mode="kernel", **blocks), a, b)


def _attention_rule(w, dims, params, q, k, v):
    p = dict(params)
    opts = {key: p.pop(key) for key in ("causal", "window", "scale")}
    q1, k1, v1 = (_first(t, d, w) for t, d in zip((q, k, v), dims))
    out = attention(q1.flatten(0, 1), k1.flatten(0, 1), v1.flatten(0, 1),
                    mode="kernel", **opts, **p)
    return out.unflatten(0, (w, q1.shape[1])), 0


def _softmax_rule(w, dims, params, x):
    """(w, R, C) softmaxes as (w·R, C) rows of one launch."""
    return softmax(_first(x, dims[0], w), mode="kernel"), 0


def _images_rule(op):
    """lrn / avgpool: (w, N, C, H, W) as (w·N, C, H, W), one launch."""

    def rule(w, dims, params, x):
        x1 = _first(x, dims[0], w)
        out = op(x1.flatten(0, 1), mode="kernel", **dict(params))
        return out.unflatten(0, (w, x1.shape[1])), 0

    return rule


def _looped_rule(op):
    """prefix_scan / sort_kv / srad_step: one launch of the op's kernel a
    member (its kernel has no batch axis)."""

    def rule(w, dims, params, *operands):
        return _per_member(w, dims, lambda *xs: op(*xs, mode="kernel", **dict(params)),
                           *operands)

    return rule


_RULES = {
    "matmul": _matmul_rule,
    "attention": _attention_rule,
    "softmax": _softmax_rule,
    "lrn": _images_rule(lrn),
    "avgpool": _images_rule(avgpool),
    "prefix_scan": _looped_rule(prefix_scan),
    "sort_kv": _looped_rule(sort_kv),
    "srad_step": _looped_rule(srad_step),
}
_OPS = {"matmul": matmul, "attention": attention, "softmax": softmax, "lrn": lrn,
        "avgpool": avgpool, "prefix_scan": prefix_scan, "sort_kv": sort_kv,
        "srad_step": srad_step}


class _KernelOp(torch.autograd.Function):
    """A kernel op behind its batching rule (:data:`_RULES`).

    The ops apply it only to a batched call; ``torch.vmap`` then calls
    :meth:`vmap` with the physical tensors and their batch dims (one level
    of vmap; a rule's own calls meet the next level the same way). Outside
    ``torch.vmap`` it runs the op's kernel route directly."""

    generate_vmap_rule = False

    @staticmethod
    def forward(op, params, *tensors):
        return _OPS[op](*tensors, mode="kernel", **dict(params))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, op, params, *tensors):
        return _RULES[op](info.batch_size, in_dims[2:], params, *tensors)
