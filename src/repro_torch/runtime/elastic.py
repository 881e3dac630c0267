"""Elastic scaling: re-mesh after node loss, resume from checkpoint.

Counterpart of ``repro/runtime/elastic.py``. ``choose_submesh`` and
``plan_remesh`` are copies (pure arithmetic): the largest valid
(data, model) grid over the surviving devices, the model (TP) degree pinned,
powers of two on the data axis. ``build_mesh`` makes the ``(data, model)``
``DeviceMesh`` over the first ``data·model`` ranks of the process group
(``runtime/sharding.py``); outside a group one device needs no mesh.
``build_pod_mesh`` makes the ``(pod, data, model)`` one the model axis
runs on.
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


def build_mesh(devices: Sequence[int] | None, data: int, model: int):
    """A ``(data, model)`` ``DeviceMesh`` over ``devices`` (ranks; the first
    ``data·model`` of the world by default), ``data`` the major axis. Every
    rank of the world calls it. Outside a process group a 1x1 grid is None
    (one device, no mesh), and a larger one raises."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    need = data * model
    avail = dist.get_world_size() if dist.is_initialized() else 1
    if need > avail:
        raise ValueError(f"a {data}x{model} mesh needs {need} devices, {avail} available")
    if not dist.is_initialized():
        return None
    ranks = list(devices if devices is not None else range(avail))[:need]
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def build_pod_mesh(pod: int, data: int, model: int, devices: Sequence[int] | None = None):
    """A ``(pod, data, model)`` ``DeviceMesh`` over ``devices`` (ranks; the
    first ``pod·data·model`` of the world by default), ``pod`` the major
    axis and ``model`` the minor, as the reference's production mesh
    (``launch/mesh.py``): a model-axis collective stays inside a host.
    Every rank of the world calls it; it needs a process group."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise ValueError("a (pod, data, model) mesh needs a process group")
    need, avail = pod * data * model, dist.get_world_size()
    if need > avail:
        raise ValueError(f"a {pod}x{data}x{model} mesh needs {need} devices, {avail} available")
    ranks = list(devices if devices is not None else range(avail))[:need]
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(pod, data, model),
                      mesh_dim_names=("pod", "data", "model"))
