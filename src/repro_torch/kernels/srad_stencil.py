"""SRAD diffusion step kernels (the SRAD benchmark; the paper's Cooperative
Groups feature).

Counterpart of ``repro/kernels/srad_stencil.py``. The kernels are CUDA C++
for Hopper in ``csrc/srad_stencil.cu`` (see the note at its top for their
bound and design). SRAD's two phases, the diffusion coefficient and the
divergence update, need a barrier across the whole image between them:

- fused: one cooperative launch (``cudaLaunchCooperativeKernel``) of no more
  blocks than fit on the card at once, walking the image in a grid-stride
  loop, with ``grid.sync()`` between the phases and the coefficient kept in
  a scratch buffer in device memory. The TPU kernel's whole image in VMEM
  does not carry over: 1024^2 f32 is 4 MiB, shared memory 227 KB a block.
- split: two ordinary launches, the coefficient written to device memory
  between them; phase 2 recomputes the differences.

- :func:`srad_step_cuda` launches either on a 2-D contiguous float32 CUDA
  image; :func:`srad_phase1_cuda` and :func:`srad_phase2_cuda` launch the
  split variant's phases one at a time. They raise on another device,
  dtype, rank or layout, and when the card cannot run a cooperative launch.
- :func:`srad_step_kernel` is the kernel route: CUDA tensors launch, CPU
  tensors run the plain version (:func:`srad_step_plain`, the ``ref.py``
  oracle; :func:`srad_phase1_plain` and :func:`srad_phase2_plain` are its
  two phases).
- ``launches`` counts launches per C entry point (a split step launches
  both phases); ``plain_calls`` counts as in ``kernels/matmul.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import srad_phase1_ref as srad_phase1_plain
from repro_torch.kernels.ref import srad_phase2_ref as srad_phase2_plain
from repro_torch.kernels.ref import srad_step_ref as srad_step_plain

__all__ = [
    "srad_step_cuda",
    "srad_phase1_cuda",
    "srad_phase2_cuda",
    "srad_step_kernel",
    "srad_step_plain",
    "srad_phase1_plain",
    "srad_phase2_plain",
    "tune_space",
    "launches",
    "plain_calls",
]

launches = {"srad_fused_f32": 0, "srad_phase1_f32": 0, "srad_phase2_f32": 0}
plain_calls = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "srad_fused_f32": [_P, _P, _P, _I, _I, _F, _F, _F, _P],
    "srad_phase1_f32": [_P, _P, _I, _I, _F, _F, _P],
    "srad_phase2_f32": [_P, _P, _P, _I, _I, _F, _P],
}


def tune_space() -> tuple[dict, ...]:
    """No block parameters (single entry): one thread per pixel in 256-thread
    blocks; the fused grid is sized by the card's occupancy."""
    return ({},)


def _f32(x: float) -> float:
    return ctypes.c_float(x).value


def _coeff_scalars(q0sqr: float) -> tuple[float, float]:
    """(q0sqr, 1 / (q0sqr * (1 + q0sqr))) as the plain version uses them on
    the card: a Python scalar rounded to f32, and a division by a scalar
    done as a multiplication by its f32 reciprocal."""
    q0 = float(q0sqr)
    return _f32(q0), _f32(1.0 / _f32(q0 * (1.0 + q0)))


def _update_scalar(lam: float) -> float:
    """0.25 * lam, computed in Python and rounded to f32, as the plain
    version's scalar multiplication does."""
    return _f32(0.25 * float(lam))


def _check(img: torch.Tensor, what: str) -> None:
    if not img.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {img.device}")
    if img.dtype != torch.float32:
        raise ValueError(f"srad kernel takes float32, got {img.dtype}")
    if img.dim() != 2:
        raise ValueError(f"srad kernel takes an (H, W) image, got shape {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError(f"srad kernel takes a contiguous image, got strides {img.stride()}")


def _launch(name: str, img: torch.Tensor, *args) -> None:
    fn = _build.function(name, _ARGTYPES[name])
    stream = torch.cuda.current_stream(img.device).cuda_stream
    _build.check(fn(*args, stream), name)
    launches[name] += 1


def srad_phase1_cuda(img: torch.Tensor, *, q0sqr: float = 0.05) -> torch.Tensor:
    """Launch phase 1 alone: the diffusion coefficient of ``img`` (H, W)."""
    _check(img, "srad_phase1_cuda")
    c = torch.empty_like(img)
    if img.numel():
        h, w = img.shape
        _launch("srad_phase1_f32", img, img.data_ptr(), c.data_ptr(), h, w,
                *_coeff_scalars(q0sqr))
    return c


def srad_phase2_cuda(img: torch.Tensor, c: torch.Tensor, *, lam: float = 0.5) -> torch.Tensor:
    """Launch phase 2 alone: the update of ``img`` by its coefficient ``c``."""
    _check(img, "srad_phase2_cuda")
    _check(c, "srad_phase2_cuda")
    if c.shape != img.shape or c.device != img.device:
        raise ValueError(f"srad phase 2: c {tuple(c.shape)} on {c.device} does not "
                         f"match the image {tuple(img.shape)} on {img.device}")
    out = torch.empty_like(img)
    if img.numel():
        h, w = img.shape
        _launch("srad_phase2_f32", img, img.data_ptr(), c.data_ptr(), out.data_ptr(),
                h, w, _update_scalar(lam))
    return out


def srad_step_cuda(
    img: torch.Tensor, *, lam: float = 0.5, q0sqr: float = 0.05, fused: bool = True
) -> torch.Tensor:
    """Launch one SRAD step on ``img`` (H, W): the cooperative fused kernel,
    or the two phases."""
    _check(img, "srad_step_cuda")
    if not fused:
        return srad_phase2_cuda(img, srad_phase1_cuda(img, q0sqr=q0sqr), lam=lam)
    out = torch.empty_like(img)
    if img.numel():
        c = torch.empty_like(img)  # the coefficient, across the grid barrier
        h, w = img.shape
        _launch("srad_fused_f32", img, img.data_ptr(), c.data_ptr(), out.data_ptr(), h, w,
                *_coeff_scalars(q0sqr), _update_scalar(lam))
    return out


def srad_step_kernel(
    img: torch.Tensor, *, lam: float = 0.5, q0sqr: float = 0.05, fused: bool = True
) -> torch.Tensor:
    """The kernel route: the CUDA kernels for a CUDA tensor, the plain
    version for a CPU tensor (the only case it runs; fused and split compute
    the same step)."""
    global plain_calls
    if img.device.type == "cpu":
        plain_calls += 1
        return srad_step_plain(img, lam=lam, q0sqr=q0sqr)
    return srad_step_cuda(img, lam=lam, q0sqr=q0sqr, fused=fused)
