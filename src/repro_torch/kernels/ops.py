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
  (``matmul`` with ``a`` sharded on its leading dim and ``b`` replicated,
  the batched product with both on the batch axis; ``softmax`` on any dim
  but the last; ``lrn`` on any dim but the channels; ``avgpool`` on batch
  or channels; ``attention`` with q, k and v on the batch; any op whose
  operands are all replicated);
- **gathered**: otherwise every operand is redistributed to ``Replicate``
  first (a ``Partial`` one reduced) and the whole op runs on every rank,
  its output replicated, as XLA runs a custom call it cannot partition.
  ``prefix_scan``, ``sort_kv`` and ``srad_step`` gather whatever is
  sharded.

Either way the op's own route runs on plain tensors: a CUDA DTensor
launches the kernel (counted under its entry) or raises, a CPU one runs
the plain versions. :data:`dtensor_rules` counts each (op, rule) taken.
Workload functions that DTensor's own propagation cannot run (a tensor
made inside from a shape, a host-checked loop) declare a rule through the
same decorator (``bench/dnn/dropout.py``, ``bench/level2/mandelbrot.py``).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
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
    "shard_dim",
    "dtensor_rules",
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

# (op, "local" or "gathered") -> calls that took that rule.
dtensor_rules: collections.Counter = collections.Counter()
_REPLICATED, _OTHER = "replicated", "other"


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def _has_dtensor(args) -> bool:
    # A plain tensor (the measured rows' case) costs one type check.
    return any(isinstance(a, torch.Tensor) and type(a) is not torch.Tensor
               and isinstance(a, _dtensor_type()) for a in args)


def _layout(t):
    """``_REPLICATED`` (not a DTensor, or replicated on every mesh dim), the
    tensor dim of an even ``Shard`` on a 1-D mesh, or ``_OTHER`` (a
    ``Partial``, an uneven shard, a mesh of more dims)."""
    if not isinstance(t, _dtensor_type()):
        return _REPLICATED
    pl = t.placements
    if all(p.is_replicate() for p in pl):
        return _REPLICATED
    if len(pl) == 1 and pl[0].is_shard():
        d = pl[0].dim % t.dim()
        if t.shape[d] % t.device_mesh.size() == 0:
            return d
    return _OTHER


def shard_dim(t) -> int | None:
    """The dim ``t`` is evenly sharded on over a 1-D mesh, else None."""
    d = _layout(t)
    return d if isinstance(d, int) else None


def sharded(name: str, local: Callable[..., int | None]):
    """Decorate ``fn`` (its tensor operands positional) with a sharding
    rule: a call with a DTensor operand runs ``fn`` on each rank's local
    shards when ``local(*operands, **kwargs)`` names the output's sharded
    dim (or every operand is replicated), else on the operands gathered to
    ``Replicate``; plain calls go straight to ``fn``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _has_dtensor(args):
                return fn(*args, **kwargs)
            from torch.distributed.tensor import Replicate, Shard

            dtensor = _dtensor_type()
            mesh = next(a.device_mesh for a in args if isinstance(a, dtensor))
            replicated = (Replicate(),) * mesh.ndim
            if all(_layout(a) == _REPLICATED for a in args):
                rule, out_pl = "local", replicated
            else:
                dim = local(*args, **kwargs)
                rule = "gathered" if dim is None else "local"
                out_pl = replicated if dim is None else (Shard(dim),)
            _build.count(dtensor_rules, (name, rule))
            plain = tuple(
                a if not isinstance(a, dtensor)
                else a.to_local() if rule == "local" else a.full_tensor()
                for a in args
            )
            out = fn(*plain, **kwargs)

            def back(t):
                return dtensor.from_local(t, mesh, out_pl, run_check=False)

            return tuple(back(t) for t in out) if isinstance(out, tuple) else back(out)

        return call

    return wrap


def _matmul_local(a, b, **_):
    """Rows (any dim of ``a`` but the contracted one) against a replicated
    2-D ``b``; a replicated 2-D ``a`` against ``b``'s columns; a batched
    ``b`` on its batch axis against a replicated 2-D ``a`` (a weight
    broadcast over images) or an ``a`` sharded alike."""
    la, lb = _layout(a), _layout(b)
    if b.dim() == 2 and lb == _REPLICATED and isinstance(la, int) and la < a.dim() - 1:
        return la
    if a.dim() == 2 == b.dim() and la == _REPLICATED and lb == 1:
        return 1
    if b.dim() == 3 and lb == 0 and (a.dim() == 2 and la == _REPLICATED
                                     or a.dim() == 3 and la == 0):
        return 0
    return None


def _attention_local(q, k, v, **_):
    return 0 if _layout(q) == _layout(k) == _layout(v) == 0 else None


def _softmax_local(x, **_):
    d = shard_dim(x)
    return d if d != x.dim() - 1 else None


def _lrn_local(x, **_):
    d = shard_dim(x)  # the window runs along the channels (dim 1)
    return d if d != 1 else None


def _avgpool_local(x, **_):
    d = shard_dim(x)  # windows tile H and W
    return d if d in (0, 1) else None


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


@sharded("attention", _attention_local)
def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    mode: Mode = "auto",
    **blocks,
):
    """GQA attention of q (B, Hq, T, D) over k, v (B, Hkv, S, D), the
    queries at the last T of the S key positions.

    On the kernel route, a call that autograd records (grad mode on, q, k
    or v requiring grad) goes through ``FlashAttentionFunction``: the
    kernel forward, the torch backward. Other calls keep the direct path."""
    use, blocks = _resolve("attention", mode, q, blocks)
    if use:
        if any(is_batched(t) for t in (q, k, v)):
            params = _frozen(dict(blocks, causal=causal, window=window, scale=scale))
            return _KernelOp.apply("attention", params, q, k, v)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _attention_mod.FlashAttentionFunction.apply(
                q, k, v, causal, window, scale, _frozen(blocks))
        return _attention_mod.flash_attention_kernel(
            q, k, v, causal=causal, window=window, scale=scale, **blocks
        )
    return _ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale)


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
