"""Level 2: ParticleFilter — Bayesian object tracking (medical imaging).

Counterpart of ``repro/bench/level2/particlefilter.py``: sequential
importance resampling. Each step propagates the particle cloud with process
noise, weights it by a Gaussian likelihood against the step's measurement,
and resamples systematically (prefix sum + ``searchsorted``).

The reference draws its noise inside the timed function from a fixed key,
so every call draws the same numbers. Here the second input is a seed: each
call seeds a ``torch.Generator`` on the measurements' device with it and
draws from that, so every call draws the same numbers again. The draws are
not the reference's; the filter is held by ``validate`` (the posterior mean
beats the raw measurements' error) and by statistics, not bit for bit. The
16 steps stay eager: a CUDA graph would have to register the generator's
state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register

PROC_STD = 0.25
MEAS_STD = 0.5


def make_trajectory(steps: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """A constant-velocity ground truth and its noisy measurements, f32."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    vel = rng.standard_normal(2) * 0.5 + 1.0
    truth = np.arange(steps)[:, None] * vel[None, :]
    meas = truth + MEAS_STD * rng.standard_normal((steps, 2))
    return truth.astype(np.float32), meas.astype(np.float32)


def particle_filter(meas: torch.Tensor, n_particles: int, seed: int) -> torch.Tensor:
    """The (steps, 2) posterior-mean track."""
    gen = torch.Generator(device=meas.device)
    gen.manual_seed(seed)
    draw = dict(generator=gen, device=meas.device, dtype=meas.dtype)
    grid = torch.arange(n_particles, device=meas.device) / n_particles
    particles = meas[0][None] + torch.randn((n_particles, 2), **draw)
    track = []
    for z in meas:
        # Propagate: random walk with drift.
        particles = particles + 1.0 + PROC_STD * torch.randn(particles.shape, **draw)
        # Weight.
        d2 = torch.sum((particles - z[None]) ** 2, dim=1)
        w = torch.softmax(-0.5 * d2 / MEAS_STD**2, dim=0)
        track.append(torch.sum(w[:, None] * particles, dim=0))
        # Systematic resampling: prefix sum + searchsorted.
        u = torch.rand((), **draw) / n_particles + grid
        idx = torch.searchsorted(torch.cumsum(w, dim=0), u)
        particles = particles[idx.clamp(0, n_particles - 1)]
    return torch.stack(track)


def track_error(track: np.ndarray, meas: np.ndarray) -> float:
    """The reference's figure: mean |track − measurement| after burn-in."""
    return float(np.abs(track[3:] - meas[3:]).mean())


def _make(n_particles: int, steps: int) -> Workload:
    def make_inputs(seed: int):
        _, meas = make_trajectory(steps, seed)
        return (torch.from_numpy(meas), seed)

    def fn(meas, seed):
        return particle_filter(meas, n_particles, seed)

    def validate(out, args):
        meas, _ = args
        assert bool(torch.isfinite(out).all()), "the track is not finite"
        err = track_error(out.cpu().numpy(), meas.cpu().numpy())
        assert err < 3 * MEAS_STD, f"filter diverged: mean err {err}"

    return Workload(
        name=f"particlefilter.p{n_particles}.s{steps}",
        fn=fn,
        make_inputs=make_inputs,
        flops=float(steps * n_particles * 30),
        bytes_moved=float(steps * n_particles * 2 * 4 * 4),
        validate=validate,
        # Opt out, as the reference: resampling gathers through a global CDF.
        batch_dims=None,
    )


register(
    BenchmarkSpec(
        name="particlefilter",
        level=2,
        dwarf="Structured grid",
        domain="Medical imaging",
        cuda_feature=None,
        gpu_feature="cumsum + searchsorted resampling, seeded device generator",
        presets=geometric_presets(
            {"n_particles": 1024, "steps": 16},
            scale_keys={"n_particles": 4.0},
            round_to=128,
        ),
        build=lambda n_particles, steps: _make(n_particles, steps),
    )
)
