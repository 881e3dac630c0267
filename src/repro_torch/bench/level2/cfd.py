"""Level 2: CFD Solver — 3-D compressible Euler equations.

Counterpart of ``repro/bench/level2/cfd.py``: the reference's
structured-grid finite-volume form of the Euler solver (Rusanov fluxes,
periodic boundaries), neighbour access as ``torch.roll`` along each axis.
The reference's ``fori_loop`` over steps is a Python loop; each step's
operations run on arrays of the whole grid (16.7 M cells at preset 4), so
launches are not what limits it and no graph is captured.

Validation, as the reference: the state stays finite with positive density.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register

GAMMA = 1.4


def _primitive(u):
    rho = u[0]
    mom = u[1:4]
    e = u[4]
    vel = mom / rho
    ke = 0.5 * torch.sum(mom * vel, dim=0)
    p = (GAMMA - 1.0) * (e - ke)
    return rho, vel, p


def _flux(u, axis: int):
    rho, vel, p = _primitive(u)
    vn = vel[axis]
    mom = [u[1 + k] * vn for k in range(3)]
    mom[axis] = mom[axis] + p  # the pressure term, along the flux's axis only
    f = torch.stack([u[0] * vn, *mom, (u[4] + p) * vn])
    a = torch.sqrt(GAMMA * p / rho)  # sound speed
    smax = torch.abs(vn) + a
    return f, smax


def euler_step(u: torch.Tensor, dt_over_dx: float = 0.1) -> torch.Tensor:
    """One Rusanov finite-volume step on state u: (5, nx, ny, nz), periodic."""
    total = torch.zeros_like(u)
    for axis in (0, 1, 2):
        ax = axis + 1  # field axis is 0
        f, smax = _flux(u, axis)
        up = torch.roll(u, -1, ax)
        fp, smaxp = _flux(up, axis)
        s = torch.maximum(smax, smaxp)[None]
        flux_r = 0.5 * (f + fp) - 0.5 * s * (up - u)  # at i+1/2
        flux_l = torch.roll(flux_r, 1, ax)  # at i-1/2
        total = total + (flux_r - flux_l)
    return u - dt_over_dx * total


def initial_state(n: int, seed: int) -> np.ndarray:
    """Density 1 + 0.1·U(0, 1), at rest, unit pressure: (5, n, n, n) f32."""
    rng = np.random.default_rng(seed)
    u = np.zeros((5, n, n, n), np.float32)
    u[0] = 1.0 + np.float32(0.1) * rng.random((n, n, n), dtype=np.float32)
    u[4] = np.float32(1.0 / (GAMMA - 1.0))
    return u


def _make(n: int, steps: int) -> Workload:
    def make_inputs(seed: int):
        return (torch.from_numpy(initial_state(n, seed)),)

    def fn(u):
        for _ in range(steps):
            u = euler_step(u)
        return u

    def validate(out, args):
        assert bool(torch.isfinite(out).all()), "CFD state diverged"
        assert bool((out[0] > 0).all()), "negative density"

    cells = n**3
    return Workload(
        name=f"cfd.{n}^3.s{steps}",
        fn=fn,
        make_inputs=make_inputs,
        flops=float(steps * cells * 3 * 60),  # the reference's ~60 a cell an axis
        bytes_moved=float(steps * cells * 5 * 4 * 4),
        validate=validate,
        # Opt out, as the reference: the periodic stencil couples neighbours.
        batch_dims=None,
    )


register(
    BenchmarkSpec(
        name="cfd",
        level=2,
        dwarf="Unstructured grid",
        domain="Computational fluid dynamics",
        cuda_feature=None,
        gpu_feature="structured-grid reformulation, eager torch ops",
        presets=geometric_presets(
            {"n": 16, "steps": 4}, scale_keys={"n": 2.0}, round_to=8
        ),
        build=lambda n, steps: _make(n, steps),
    )
)
