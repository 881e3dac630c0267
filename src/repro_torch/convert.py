"""Carry the reference's arrays across into the port's tensors.

The parity tests build inputs once, through the reference's
``make_inputs`` (or a numpy generator), and hand the same values to both
packages. The reference's arrays arrive here as numpy arrays (callers pass
``np.asarray(x)``); this module imports no JAX.

bfloat16 needs a detour: ``np.asarray`` of a JAX bfloat16 array has the
``ml_dtypes`` bfloat16 dtype, which ``torch.from_numpy`` refuses. Such
arrays go through float32 (exact) and then ``.to(torch.bfloat16)`` (exact
again, since every value came from bfloat16).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import AdamWState

__all__ = ["from_reference", "model_state_from_reference", "adamw_state_from_reference"]


def _tensor(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    # A copy: arrays that come from JAX are read-only, and torch tensors
    # over read-only memory are not safe to write.
    return torch.from_numpy(np.array(arr))


def from_reference(
    arrays: Iterable, device: str | torch.device = "cuda"
) -> tuple[torch.Tensor, ...]:
    """The port's tensors on ``device`` for the reference's arrays."""
    return tuple(_tensor(a).to(device) for a in arrays)


def _leaves(tree: dict, prefix: str = ""):
    """(dotted name, leaf) for every leaf of a nested dict."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}.")
        else:
            yield prefix + name, value


def model_state_from_reference(cfg: ArchConfig, params: dict) -> dict[str, torch.Tensor]:
    """The port's ``Model`` state dict for the reference's ``Model.init``
    parameters, given as numpy arrays (``jax.tree.map(np.asarray, params)``).

    The reference stacks every block leaf over the periods of its layer scan:
    ``params["blocks"]`` is a tuple over the P positions of the period
    (``cfg.block_period()``: 1 block for a dense or MoE stack, 2 for xLSTM,
    8 for jamba), each leaf with a leading ``n_periods`` axis. The port holds
    one block per layer, so the reference's leaf ``blocks[j][group][name]``
    row n is the port's ``blocks.<n*P + j>.<group>.<name>`` (an xLSTM block's
    leaves have no group), and a top-level leaf keeps its name. An MoE
    block's ``ffn`` leaves are (E, d, ff) and the like after that axis. The
    weights keep their (d_in, d_out) layout on both sides.

    Any tree shaped like the parameters converts the same way (gradients,
    AdamW moments), so a test compares them name for name.
    """
    period = cfg.block_period()
    blocks = params["blocks"]
    if len(blocks) != len(period):
        raise ValueError(f"{cfg.name}: {len(blocks)} blocks in the reference's period, the "
                         f"config's period {period} has {len(period)}")
    state = {}
    for j, tree in enumerate(blocks):
        for name, leaf in _leaves(tree):
            arr = np.asarray(leaf)
            if arr.shape[0] != cfg.n_periods:
                raise ValueError(f"blocks[{j}] leaf {name} has {arr.shape[0]} periods, not "
                                 f"{cfg.n_periods}")
            for n in range(cfg.n_periods):
                state[f"blocks.{n * len(period) + j}.{name}"] = _tensor(arr[n])
    for name in ("ln_f", "embed", "unembed"):
        if name in params:
            state[name] = _tensor(params[name])
    return state


def adamw_state_from_reference(cfg: ArchConfig, state) -> AdamWState:
    """The port's ``AdamWState`` (on the CPU) for the reference's, given as
    numpy arrays (``jax.tree.map(np.asarray, state)``): the step counter as
    a 0-d int32 tensor, each moment by the port's parameter name."""
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        m=model_state_from_reference(cfg, state.m),
        v=model_state_from_reference(cfg, state.v),
    )
