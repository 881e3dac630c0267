"""Elastic scaling: re-mesh after node loss, resume from checkpoint.

Counterpart of ``repro/runtime/elastic.py``. ``choose_submesh`` and
``plan_remesh`` are copies (pure arithmetic): the largest valid
(data, model) grid over the surviving devices, the model (TP) degree pinned,
powers of two on the data axis. ``build_mesh`` over more than one device is
placement over several GPUs, ROADMAP.md queue 1, item 12: it raises. One
device needs no mesh, which is how ``launch/train.py`` runs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["choose_submesh", "plan_remesh", "RemeshPlan", "build_mesh"]


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    data: int
    model: int
    devices_used: int
    devices_idle: int
    global_batch_ratio: float  # new_data / old_data


def choose_submesh(n_devices: int, *, model: int, max_data: int | None = None) -> tuple[int, int]:
    """Largest (data, model) with data·model ≤ n_devices, model fixed."""
    if n_devices < model:
        raise ValueError(
            f"cannot keep model axis {model} with only {n_devices} devices; "
            "restore requires at least one full TP group"
        )
    data = n_devices // model
    if max_data is not None:
        data = min(data, max_data)
    # Prefer powers of two on the data axis (collective-friendly rings).
    p = 1
    while p * 2 <= data:
        p *= 2
    return p, model


def plan_remesh(
    old_mesh_shape: tuple[int, int],
    surviving_devices: int,
) -> RemeshPlan:
    old_data, model = old_mesh_shape
    data, model = choose_submesh(surviving_devices, model=model)
    return RemeshPlan(
        data=data,
        model=model,
        devices_used=data * model,
        devices_idle=surviving_devices - data * model,
        global_batch_ratio=data / old_data,
    )


def build_mesh(devices: Sequence | None, data: int, model: int) -> None:
    """None for one device (no mesh); a grid of more raises."""
    if data * model > 1:
        raise NotImplementedError(
            f"a {data}x{model} device mesh is placement over several GPUs: ROADMAP.md "
            "queue 1, item 12; the port trains on one device, without a mesh"
        )
    return None
