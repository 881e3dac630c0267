"""Level 2: KMeans — Lloyd iterations (data mining).

Counterpart of ``repro/bench/level2/kmeans.py``. Assignment is a dense
distance matmul (‖x−c‖² = ‖x‖² − 2x·cᵀ + ‖c‖²) and an ``argmin`` (the
first index on a tie, as ``jnp.argmin``); the update is the reference's
one-hot matmul segment mean, kept because it is the benchmark's feature
(the GPU original accumulates with atomics). Both products are
``torch.matmul`` calls, in f32 with TF32 off, as the reference computes
them outside any Pallas kernel. Validation: inertia is non-increasing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register


def assign(points: torch.Tensor, centers: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(nearest center, squared distances (N, K)) for each point."""
    x2 = torch.sum(points * points, dim=1, keepdim=True)  # (N, 1)
    c2 = torch.sum(centers * centers, dim=1)[None]  # (1, K)
    d2 = x2 - 2.0 * points @ centers.T + c2  # (N, K)
    return torch.argmin(d2, dim=1), d2


def kmeans_step(points: torch.Tensor, centers: torch.Tensor):
    """One Lloyd iteration. points (N, D), centers (K, D) -> (centers', inertia)."""
    nearest, d2 = assign(points, centers)
    inertia = torch.sum(torch.min(d2, dim=1).values)
    onehot = F.one_hot(nearest, centers.shape[0]).to(points.dtype)  # (N, K)
    sums = onehot.T @ points  # (K, D)
    counts = torch.sum(onehot, dim=0)[:, None]
    new_centers = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), centers)
    return new_centers, inertia


def kmeans(points: torch.Tensor, centers: torch.Tensor, iters: int):
    """``iters`` Lloyd iterations -> (centers, inertia of each iteration)."""
    history = []
    for _ in range(iters):
        centers, inertia = kmeans_step(points, centers)
        history.append(inertia)
    return centers, torch.stack(history)


def _make(n: int, d: int, k: int, iters: int) -> Workload:
    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        pts = rng.standard_normal((n, d), dtype=np.float32)
        ctr = pts[rng.choice(n, k, replace=False)]
        return (torch.from_numpy(pts), torch.from_numpy(ctr))

    def fn(points, centers):
        return kmeans(points, centers, iters)

    def validate(out, args):
        _, history = out
        h = history.cpu().numpy()
        assert np.all(np.diff(h) <= 1e-2 * np.abs(h[:-1]) + 1e-3), (
            f"k-means inertia increased: {h}"
        )

    return Workload(
        name=f"kmeans.n{n}.d{d}.k{k}.i{iters}",
        fn=fn,
        make_inputs=make_inputs,
        flops=float(iters * (2.0 * n * d * k + 2.0 * n * k * d)),
        bytes_moved=float(iters * n * d * 4 * 2),
        validate=validate,
        # As the reference: points shard over rows, centers replicate.
        batch_dims=(0, None),
    )


register(
    BenchmarkSpec(
        name="kmeans",
        level=2,
        dwarf="Dense linear algebra",
        domain="Data mining",
        cuda_feature=None,
        gpu_feature="one-hot matmul segment reduce (torch.matmul, f32)",
        presets=geometric_presets(
            {"n": 4096, "d": 16, "k": 16, "iters": 5},
            scale_keys={"n": 4.0, "d": 2.0},
            round_to=8,
        ),
        build=lambda n, d, k, iters: _make(n, d, k, iters),
    )
)
