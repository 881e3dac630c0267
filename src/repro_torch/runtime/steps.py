"""Train / eval step factories.

Counterpart of ``repro/runtime/steps.py``: ``make_train_step`` wires the
model's loss through its gradient, global-norm clipping, the schedule and
AdamW into one step, with optional microbatch gradient accumulation
(``accum > 1`` slices the batch, adds the f32 gradients and takes the mean
of the microbatches' losses). The reference's step is a pure function whose
buffers the caller donates; here the step updates the model's parameters
and the optimizer state in place and returns the state, so no second copy
of either exists. Its metrics stay device tensors: a step makes no host read.
The batch is any dict the model's ``loss_fn`` takes: tokens, or embeddings
with their positions; ``accum`` slices every leaf on its leading axis.
``data_group`` makes the step data parallel over a ``torch.distributed``
group whose ranks hold equal shares of the global batch: after the
gradients (and any accumulation) the gradients and the loss are summed over
the group and divided by its size, before clipping and AdamW, so every rank
takes the global batch's step. They travel as one flat buffer a dtype: one
explicit all-reduce and one division each, not one a leaf; each element is
still summed over the same ranks, in a dtype of its own.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.clip import clip_by_global_norm

__all__ = ["make_train_step", "make_eval_step"]


def _microbatch(leaf: torch.Tensor, i: int, accum: int) -> torch.Tensor:
    mb = leaf.shape[0] // accum
    return leaf[i * mb:(i + 1) * mb]


def _mean_over(group: Any, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each tensor summed over ``group`` and divided by its size, as views of
    one flat buffer a dtype (one all-reduce and one division each)."""
    n = dist.get_world_size(group)
    out: list[Any] = [None] * len(tensors)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)
        for i, v in zip(idx, flat.split([tensors[i].numel() for i in idx]), strict=True):
            out[i] = v.view(tensors[i].shape)
    return out


def make_train_step(
    model: Model,
    optimizer: AdamW,
    schedule: Callable[[torch.Tensor], torch.Tensor],
    *,
    clip_norm: float = 1.0,
    accum: int = 1,
    data_group: Any = None,
):
    """-> ``train_step(opt_state, batch) -> (opt_state, metrics)``: one
    optimizer step on ``batch`` (a dict of (B, ...) tensors on the model's
    device), ``metrics`` {"loss", "tokens", "grad_norm", "lr"}."""
    params = dict(model.named_parameters())

    def grads_of(batch):
        loss, metrics = model.loss_fn(batch)
        # A leaf the loss does not reach (an embeddings model's token table
        # where the unembedding is its own) gets a zero gradient, as under
        # the reference's jax.grad.
        grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
        return loss.detach(), metrics, dict(zip(params, grads, strict=True))

    def train_step(opt_state: AdamWState, batch: dict) -> tuple[AdamWState, dict]:
        if accum == 1:
            loss, metrics, grads = grads_of(batch)
            metrics = {"loss": loss, "tokens": metrics["tokens"]}
        else:
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for k, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=opt_state.step.device)
            for i in range(accum):
                loss, _, grads = grads_of({k: _microbatch(v, i, accum) for k, v in batch.items()})
                for k, g in grads.items():
                    gsum[k] += g
                lsum = lsum + loss
            grads = {k: g / accum for k, g in gsum.items()}
            loss = lsum / accum
            # As the reference's accumulated step, which counts no tokens.
            metrics = {"loss": loss, "tokens": torch.zeros_like(loss)}
        if data_group is not None:
            *reduced, metrics["loss"] = _mean_over(data_group, [*grads.values(), metrics["loss"]])
            grads = dict(zip(grads, reduced, strict=True))
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = schedule(opt_state.step)
        opt_state = optimizer.update(grads, opt_state, params, lr)
        metrics.update({"grad_norm": gnorm, "lr": lr})
        return opt_state, metrics

    return train_step


def make_eval_step(model: Model):
    """-> ``eval_step(batch) -> metrics`` ({"loss", "tokens"}), no gradient."""

    def eval_step(batch: dict) -> dict:
        with torch.no_grad():
            _, metrics = model.loss_fn(batch)
        return metrics

    return eval_step
