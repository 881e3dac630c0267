"""Host-checked loops under ``torch.vmap``.

The reference ends BFS's level loop and Mandelbrot's escape loop with a
``lax.while_loop``; ``jax.vmap`` of it (the serve stage's width-w call,
``repro/core/engine.py:747``) runs until no member is active. The port ends
those loops on the host, with one scalar read a round, and ``torch.vmap``
cannot read a batched value on the host.

:func:`rows_call` gives such a loop its batching rule, as ``_KernelOp``
does for the kernel ops (``kernels/ops.py``): ``fn`` takes its tensors with
a leading member axis. Outside ``torch.vmap`` it runs over one member
(``t[None]`` in, ``[0]`` out); under ``torch.vmap`` over the physical batch,
so its host check sees every member and the loop runs until none is
active. A member that finished early takes the extra rounds unchanged (an
escaped pixel is frozen, an empty frontier marks nothing), so each member
gets what its width-1 call gets, bit for bit.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["rows_call"]


class _Rows(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(fn, *tensors):
        out = fn(*(t.unsqueeze(0) for t in tensors))
        return out[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, fn, *tensors):
        w = info.batch_size
        rows = [t.unsqueeze(0).expand(w, *t.shape) if d is None else t.movedim(d, 0)
                for t, d in zip(tensors, in_dims[1:])]
        return fn(*rows), 0


def rows_call(fn: Callable[..., torch.Tensor], *tensors: torch.Tensor) -> torch.Tensor:
    """``fn(*rows)[0]`` for ``rows`` the tensors with a leading axis of one
    member; under ``torch.vmap``, ``fn`` over every member at once."""
    return _Rows.apply(fn, *tensors)
