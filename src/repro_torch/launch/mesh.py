"""Production meshes: 16×16 single pod (256 devices), 2×16×16 multi-pod (512).

Counterpart of ``repro/launch/mesh.py``. The reference builds a
``jax.sharding.Mesh`` over forced host devices; the port's dry run needs
only the mesh's axis sizes, which ``runtime.sharding.ShardingRules`` takes
as a plain mapping: no process group of 256 or 512 ranks is created.
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "data_axes", "POD_SHAPE", "MULTI_POD_SHAPE"]

POD_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def make_production_mesh(*, multi_pod: bool = False) -> dict[str, int]:
    """Axis name -> size, major axis first."""
    shape = MULTI_POD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def data_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)
