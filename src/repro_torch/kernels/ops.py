"""Public entry points of the kernel layer.

Counterpart of ``repro/kernels/ops.py``. Each op dispatches between its
hand-written kernel and its plain PyTorch oracle (``kernels/ref.py``):

- ``mode="kernel"`` takes the kernel route: CUDA tensors launch the CUDA
  kernel (or raise), CPU tensors run the plain version, which is how the
  reference runs a Pallas kernel interpreted off-TPU;
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
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Literal

import torch

from repro_torch.kernels import avgpool as _avgpool_mod
from repro_torch.kernels import bitonic_sort as _sort_mod
from repro_torch.kernels import lrn as _lrn_mod
from repro_torch.kernels import matmul as _matmul_mod
from repro_torch.kernels import prefix_scan as _scan_mod
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import softmax as _softmax_mod
from repro_torch.kernels import srad_stencil as _srad_mod

__all__ = [
    "matmul", "softmax", "lrn", "avgpool", "srad_step", "prefix_scan", "sort_kv",
    "force_impl", "tune_space", "KERNEL_OPS", "MODES",
]

Mode = Literal["auto", "kernel", "ref"]
MODES = ("auto", "kernel", "ref")

# op name -> kernel module exporting tune_space(). A Workload's ``kernel``
# field names one of these keys (registry.py impl contract).
KERNEL_OPS = {
    "matmul": _matmul_mod,
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


def tune_space(op: str) -> tuple[dict, ...]:
    """The autotune candidates for ``op`` (first entry = kernel defaults)."""
    try:
        module = KERNEL_OPS[op]
    except KeyError:
        raise KeyError(f"unknown kernel op {op!r}; known: {sorted(KERNEL_OPS)}") from None
    return module.tune_space()


def matmul(a: torch.Tensor, b: torch.Tensor, *, mode: Mode = "auto", **blocks):
    """(M, K) or (B, M, K) @ (K, N) or (B, K, N), batches broadcast as in
    ``torch.matmul``."""
    use, blocks = _resolve("matmul", mode, a, blocks)
    if use:
        return _matmul_mod.matmul_kernel(a, b, **blocks)
    return _ref.matmul_ref(a, b)


def softmax(x: torch.Tensor, *, mode: Mode = "auto"):
    use, _ = _resolve("softmax", mode, x, {})  # no block parameters
    if use:
        return _softmax_mod.softmax_kernel(x)
    return _ref.softmax_ref(x)


def lrn(x: torch.Tensor, *, size=5, alpha=1e-4, beta=0.75, k=2.0, mode: Mode = "auto"):
    use, _ = _resolve("lrn", mode, x, {})  # no block parameters
    if use:
        return _lrn_mod.lrn_kernel(x, size=size, alpha=alpha, beta=beta, k=k)
    return _ref.lrn_ref(x, size=size, alpha=alpha, beta=beta, k=k)


def avgpool(x: torch.Tensor, *, ksize=2, mode: Mode = "auto"):
    use, _ = _resolve("avgpool", mode, x, {})  # no block parameters
    if use:
        return _avgpool_mod.avgpool_kernel(x, ksize=ksize)
    return _ref.avgpool_ref(x, ksize=ksize)


def srad_step(img: torch.Tensor, *, lam=0.5, q0sqr=0.05, fused: bool = True,
              mode: Mode = "auto"):
    """One SRAD step: the cooperative fused kernel, or its two phases."""
    use, _ = _resolve("srad_step", mode, img, {})  # no block parameters
    if use:
        return _srad_mod.srad_step_kernel(img, lam=lam, q0sqr=q0sqr, fused=fused)
    return _ref.srad_step_ref(img, lam=lam, q0sqr=q0sqr)


def prefix_scan(x: torch.Tensor, *, mode: Mode = "auto", **blocks):
    use, blocks = _resolve("prefix_scan", mode, x, blocks)
    if use:
        return _scan_mod.prefix_scan_kernel(x, **blocks)
    return _ref.prefix_scan_ref(x)


def sort_kv(keys: torch.Tensor, values: torch.Tensor, *, mode: Mode = "auto"):
    """Ascending key sort carrying values. The kernel route needs no padding
    (the reference pads to a power of two for its bitonic network)."""
    use, _ = _resolve("sort_kv", mode, keys, {})  # no block parameters
    if use:
        return _sort_mod.sort_kv_kernel(keys, values)
    return _ref.sort_kv_ref(keys, values)
