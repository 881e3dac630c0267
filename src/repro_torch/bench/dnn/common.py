"""Shared scaffolding for the DNN-section benchmarks (paper §IV-A.4).

Counterpart of ``repro/bench/dnn/common.py``. Every DNN benchmark reports
both passes (Figs. 3 and 4): ``fn`` is the layer forward; ``fn_bwd``
returns the gradients of a scalar loss (the sum of the means of the float
outputs) with respect to every floating-point input, through
``torch.autograd.grad`` — what the cuDNN backward kernels of Table II
compute. Backward FLOPs default to twice the forward's.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.registry import Workload

__all__ = ["dnn_workload"]


def _mean_of_outputs(out) -> torch.Tensor:
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    return sum(
        leaf.float().mean() for leaf in leaves
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
    )


def dnn_workload(
    name: str,
    fn: Callable,
    make_inputs: Callable[[int], tuple],
    *,
    flops: float,
    bytes_moved: float,
    flops_bwd: float | None = None,
    validate: Callable | None = None,
    diff_argnums: tuple[int, ...] | None = None,
    batch_dims: tuple[int | None, ...] | None = None,
    kernel: str | None = None,
) -> Workload:
    if diff_argnums is None or batch_dims is None:
        # Arity and dtypes, from one call of make_inputs at a fixed seed.
        # Benchmarks with large inputs pass both explicitly instead.
        sample = make_inputs(0)
    if diff_argnums is None:
        diff_argnums = tuple(
            i for i, a in enumerate(sample)
            if isinstance(a, torch.Tensor) and a.is_floating_point()
        )

    def grad_fn(*args):
        args = list(args)
        wrt = [args[i].detach().requires_grad_(True) for i in diff_argnums]
        for i, t in zip(diff_argnums, wrt, strict=True):
            args[i] = t
        with torch.enable_grad():
            loss = _mean_of_outputs(fn(*args))
            return torch.autograd.grad(loss, wrt)

    # Every DNN layer is data-parallel over the batch dim of its activation
    # input (arg 0); weights replicate.
    if batch_dims is None:
        batch_dims = (0,) + (None,) * (len(sample) - 1)
    return Workload(
        name=name,
        fn=fn,
        make_inputs=make_inputs,
        flops=flops,
        bytes_moved=bytes_moved,
        validate=validate,
        fn_bwd=grad_fn if diff_argnums else None,
        flops_bwd=flops_bwd if flops_bwd is not None else 2.0 * flops,
        batch_dims=batch_dims,
        kernel=kernel,
        meta={"dnn": True},
    )
