"""AdamW with a configurable moment dtype, updating in place.

Counterpart of ``repro/optim/adamw.py``. ``moment_dtype="bfloat16"`` halves
the optimizer state. Bias correction runs in f32 from the step counter, an
int32 tensor on the device; the update is computed in f32 and cast back into
the parameter's dtype. Weight decay applies to tensors of two or more
dimensions (norm gains and biases are exempt).

The reference returns new parameters and state and donates the old buffers
to the compiled step (``repro/launch/train.py``); here ``update`` writes the
parameters, the moments and the step counter in place, under ``no_grad``,
which is what that donation buys.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["AdamW", "AdamWState"]

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor  # 0-d int32, on the parameters' device
    m: dict[str, torch.Tensor]  # by parameter name
    v: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"

    def _dtype(self) -> torch.dtype:
        try:
            return _MOMENT_DTYPES[self.moment_dtype]
        except KeyError:
            raise ValueError(
                f"moment_dtype {self.moment_dtype!r} not one of {sorted(_MOMENT_DTYPES)}"
            ) from None

    def init(self, params: dict[str, torch.Tensor]) -> AdamWState:
        dt = self._dtype()
        device = next(iter(params.values())).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            # zeros_like: a DTensor parameter's moments are DTensors placed
            # as it is, each rank holding its shard's.
            m={k: torch.zeros_like(p, dtype=dt, memory_format=torch.contiguous_format)
               for k, p in params.items()},
            v={k: torch.zeros_like(p, dtype=dt, memory_format=torch.contiguous_format)
               for k, p in params.items()},
        )

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: AdamWState,
               params: dict[str, torch.Tensor], lr: torch.Tensor) -> AdamWState:
        """One step: ``params``, ``state.m``, ``state.v`` and ``state.step``
        updated in place (``state`` is returned). ``lr`` is a 0-d f32 tensor
        or a float."""
        b1, b2 = self.b1, self.b2
        state.step.add_(1)
        t = state.step.to(torch.float32)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        for name, p in params.items():
            gf = grads[name].float()
            m, v = state.m[name], state.v[name]
            mf = b1 * m.float() + (1 - b1) * gf
            vf = b2 * v.float() + (1 - b2) * gf * gf
            mhat = mf / c1
            vhat = vf / c2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if p.dim() >= 2:  # decay matrices only (norms/bias exempt)
                delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(mf)
            v.copy_(vf)
        return state
