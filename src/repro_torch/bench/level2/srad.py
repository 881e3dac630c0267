"""Level 2: SRAD — speckle-reducing anisotropic diffusion (computer vision).

Counterpart of ``repro/bench/level2/srad.py``, the Cooperative Groups
benchmark (paper §V-B): a loop of SRAD steps on the hand-written kernels
(``--impl kernel``, ``kernels/srad_stencil.py``) or the plain oracle. With
``fused=True`` (the presets) each step is one cooperative launch with a
grid-wide barrier between its two phases; ``fused=False`` (an override,
``--override srad.fused=false``) launches the phases one after the other.
On the card the loop of steps runs as one CUDA graph replay a call, on
either route, as the reference's engine jits its ``fori_loop``.
q0sqr follows Rodinia's default speckle scale for synthetic inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graphs import GraphCache
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register
from repro_torch.kernels import ops

Q0SQR = 0.05  # Rodinia default speckle scale for synthetic inputs
GRAPHS = GraphCache()


def _steps(img: torch.Tensor, iters: int, lam: float, fused: bool) -> torch.Tensor:
    for _ in range(iters):
        img = ops.srad_step(img, lam=lam, q0sqr=Q0SQR, fused=fused)
    return img


def graph_key(img: torch.Tensor, iters: int, lam: float, fused: bool) -> tuple:
    """What a captured loop depends on: the image's address and layout, the
    loop's parameters and the route ``ops.srad_step`` takes under the active
    ``force_impl``."""
    return (img.data_ptr(), tuple(img.shape), img.stride(), img.dtype, img.device, iters,
            lam, Q0SQR, fused, ops.takes_kernel("srad_step", img))


def srad_iterations(img: torch.Tensor, iters: int, lam: float, fused: bool) -> torch.Tensor:
    """``iters`` SRAD steps (the reference's ``fori_loop``).

    On a CPU image, a Python loop. On a CUDA image, one replay of a CUDA
    graph of the loop (:data:`GRAPHS`, keyed by :func:`graph_key`): the
    first call for a key runs the loop eagerly and captures it, each later
    call replays it and returns the graph's static output tensor, which the
    next call with the same key overwrites. Under ``torch.vmap`` the loop
    runs eagerly, each step through ``srad_step``'s batching rule."""
    if not img.is_cuda or iters == 0 or ops.is_batched(img):
        return _steps(img, iters, lam, fused)
    counters = [mod.launches for mod in ops.KERNEL_OPS.values()]
    return GRAPHS(graph_key(img, iters, lam, fused), _steps, (img, iters, lam, fused),
                  counters)


def _make(n: int, iters: int, fused: bool = True) -> Workload:
    # A bool, or 0/1 (what the reference's CLI can pass). A string such as
    # "False" is refused rather than taken as true.
    if fused not in (True, False):
        raise TypeError(f"srad's fused takes a bool, got {fused!r}")
    fused = bool(fused)

    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        # Positive speckled image (exponential of Gaussian, as in Rodinia).
        noise = rng.standard_normal((n, n), dtype=np.float32)
        return (torch.from_numpy(np.exp(np.float32(0.1) * noise)),)

    def fn(img):
        return srad_iterations(img, iters, lam=0.5, fused=fused)

    def validate(out, args):
        (img,) = args
        assert bool(torch.isfinite(out).all()), "SRAD diverged"
        # Diffusion must reduce speckle variance (population variance, as
        # numpy's in the reference).
        assert out.double().var(correction=0) <= img.double().var(correction=0) * 1.01

    return Workload(
        name=f"srad.{n}x{n}.i{iters}.{'fused' if fused else 'split'}",
        fn=fn,
        make_inputs=make_inputs,
        flops=float(iters * n * n * 40),
        bytes_moved=float(iters * n * n * 4 * (2 if fused else 4)),
        validate=validate,
        # Opt out, as the reference: the stencil needs halos each iteration.
        batch_dims=None,
        kernel="srad_step",
    )


register(
    BenchmarkSpec(
        name="srad",
        level=2,
        dwarf="Structured grid",
        domain="Computer vision",
        cuda_feature="Cooperative Groups",
        gpu_feature="cooperative launch with grid.sync() between the phases (CUDA)",
        presets=geometric_presets(
            {"n": 64, "iters": 4, "fused": True}, scale_keys={"n": 2.0}, round_to=16
        ),
        build=lambda n, iters, fused: _make(n, iters, fused),
    )
)
