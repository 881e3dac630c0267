"""Production meshes: 16×16 single pod (256 devices), 2×16×16 multi-pod (512).

Counterpart of ``repro/launch/mesh.py``. The reference builds a
``jax.sharding.Mesh`` over forced host devices. The port's dry run takes
the mesh's axis sizes (``make_production_mesh``, a plain mapping that
``runtime.sharding.ShardingRules`` takes), and, to trace a cell as one rank
of that mesh, :func:`mesh_rank`: rank 0 of a ``"fake"`` process group of
the mesh's size (``torch.testing._internal.distributed.fake_pg``, which
ships with torch: its collectives return at once and move nothing) and the
``(pod, data, model)`` ``DeviceMesh`` that ``runtime/elastic.py::
build_pod_mesh`` builds over it, on device type ``cpu``, for DTensors whose
local shards live on the ``meta`` device.
"""

from __future__ import annotations

import contextlib
from typing import Mapping

__all__ = ["make_production_mesh", "data_axes", "mesh_rank", "POD_SHAPE", "MULTI_POD_SHAPE"]

POD_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def make_production_mesh(*, multi_pod: bool = False) -> dict[str, int]:
    """Axis name -> size, major axis first."""
    shape = MULTI_POD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def data_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


@contextlib.contextmanager
def mesh_rank(sizes: Mapping[str, int]):
    """Rank 0 of a mesh of axis ``sizes`` (``data`` and ``model``, with or
    without ``pod``: a single pod is a pod axis of 1), yielding its
    ``(pod, data, model)`` ``DeviceMesh``. It makes the default process
    group, a ``"fake"`` one of ``pod·data·model`` ranks, and destroys it on
    exit, whatever happens inside; where a default group exists already it
    raises, never reusing that group or leaving its own behind."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.runtime.elastic import build_pod_mesh

    unknown = set(sizes) - {"pod", "data", "model"}
    if unknown:
        raise ValueError(f"a production mesh has axes pod, data and model, not {sorted(unknown)}")
    if dist.is_initialized():
        raise RuntimeError("a default process group exists: a rank of the production mesh "
                           "makes its own and never reuses one")
    pod, data, model = sizes.get("pod", 1), sizes["data"], sizes["model"]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=pod * data * model)
    try:
        yield build_pod_mesh(pod, data, model)
    finally:
        dist.destroy_process_group()
