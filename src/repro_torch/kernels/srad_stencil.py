"""SRAD diffusion step kernels (the SRAD benchmark; the paper's Cooperative
Groups feature).

Counterpart of ``repro/kernels/srad_stencil.py``. The kernels are CUDA C++
for Hopper in ``csrc/srad_stencil.cu`` (see the note at its top for their
bound and design). SRAD's two phases, the diffusion coefficient and the
divergence update, need a barrier across the whole image between them.
Five C entry points:

- ``srad_fused_f32``: one cooperative launch of at most one CTA an SM, each
  holding a band of whole rows (plus a halo row above and below) and the
  band's coefficient in shared memory, with one ``grid.sync()`` between the
  phases: the TPU kernel's "c never leaves fast memory", across the card.
  It takes every image whose band fits a CTA's shared memory
  (:func:`band_smem_bytes`).
- ``srad_fused_f32_gridstride``: the first design, a cooperative launch of
  occupancy x SMs blocks walking the image, the coefficient in a
  device-memory scratch; the images no band fits take it.
- ``srad_phase1_f32``: the split variant's phase 1 as a float4 row walk, for
  W % 4 == 0 on a 16-byte aligned base; ``srad_phase1_f32_scalar`` (one
  thread a pixel) for every other image; ``srad_phase2_f32``, phase 2.

- :func:`_route` names the entry an image goes to, from dtype, shape,
  address and the card's SM count and shared memory (arguments, so it
  answers for CPU tensors too); it raises on another dtype, rank or layout.
- :func:`srad_step_cuda` launches that entry on a CUDA image;
  :func:`srad_phase1_cuda` and :func:`srad_phase2_cuda` launch the split
  variant's phases one at a time. They raise on another device, dtype, rank
  or layout, and when the card cannot run a cooperative launch.
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
    "bands",
    "band_smem_bytes",
    "card_limits",
    "tune_space",
    "launches",
    "plain_calls",
]

launches = {
    "srad_fused_f32": 0, "srad_fused_f32_gridstride": 0,
    "srad_phase1_f32": 0, "srad_phase1_f32_scalar": 0, "srad_phase2_f32": 0,
}
plain_calls = 0

FUSED_ENTRIES = ("srad_fused_f32", "srad_fused_f32_gridstride")
PHASE1_ENTRIES = ("srad_phase1_f32", "srad_phase1_f32_scalar")
WALK_ROWS = 2  # rows a thread of srad_phase1_f32 walks (csrc: kWalkRows)
MAX_WALK_H = 65535 * WALK_ROWS  # srad_phase1_f32's grid y extent

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "srad_fused_f32": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _P],
    "srad_fused_f32_gridstride": [_P, _P, _P, _I, _I, _F, _F, _F, _P],
    "srad_phase1_f32": [_P, _P, _I, _I, _F, _F, _P],
    "srad_phase1_f32_scalar": [_P, _P, _I, _I, _F, _F, _P],
    "srad_phase2_f32": [_P, _P, _P, _I, _I, _F, _P],
}
_LIMITS: dict[int, tuple[int, int]] = {}


def tune_space() -> tuple[dict, ...]:
    """No block parameters (single entry): the fused step's bands follow
    from the image and the card's SM count, the other kernels' blocks are
    fixed."""
    return ({},)


def bands(h: int, sms: int) -> tuple[int, int]:
    """(CTAs, rows a band) of ``srad_fused_f32`` for an image of ``h`` rows
    on ``sms`` SMs: bands of ceil(h / min(h, sms)) whole rows, at most one
    CTA an SM."""
    rows = -(-h // min(h, sms))
    return -(-h // rows), rows


def band_smem_bytes(h: int, w: int, sms: int) -> int:
    """Shared memory a CTA of ``srad_fused_f32`` takes (csrc:
    band_smem_bytes): the band's rows, a halo row above and below and the
    band's coefficient plus the next band's first row, each row padded to a
    multiple of 4 floats."""
    rows = bands(h, sms)[1]
    return (2 * rows + 3) * (-(-w // 4) * 4) * 4


def card_limits(device: torch.device) -> tuple[int, int]:
    """(SMs, shared memory a CTA may opt in to) of the CUDA ``device``, from
    the C query (which also checks that the card runs cooperative launches),
    asked once per device."""
    if device.type != "cuda":
        raise ValueError(f"the SRAD kernels' limits need a CUDA device, got {device}")
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _LIMITS:
        out = (ctypes.c_int * 2)()
        fn = _build.function("srad_band_limits", [ctypes.POINTER(ctypes.c_int)])
        with torch.cuda.device(index):
            _build.check(fn(out), "srad_band_limits")
        _LIMITS[index] = (out[0], out[1])
    return _LIMITS[index]


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


def _check_layout(img: torch.Tensor) -> None:
    if img.dtype != torch.float32:
        raise ValueError(f"srad kernel takes float32, got {img.dtype}")
    if img.dim() != 2:
        raise ValueError(f"srad kernel takes an (H, W) image, got shape {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError(f"srad kernel takes a contiguous image, got strides {img.stride()}")


def _check(img: torch.Tensor, what: str) -> None:
    if not img.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {img.device}")
    _check_layout(img)


def _route(img: torch.Tensor, *, fused: bool = True,
           limits: tuple[int, int] | None = None) -> str:
    """The C entry point ``img`` goes to: fused, ``srad_fused_f32`` where
    :func:`band_smem_bytes` fits the shared memory a CTA may have, else
    ``srad_fused_f32_gridstride``; split (phase 1), ``srad_phase1_f32`` for
    W % 4 == 0 on a 16-byte aligned base, else ``srad_phase1_f32_scalar``.
    ``limits`` is the card's (SMs, shared memory a CTA may opt in to); the
    fused route asks the card (:func:`card_limits`) when it is not given.
    Raises ``ValueError`` on another dtype, rank or layout. An empty image
    goes to the first entry, which launches nothing for it."""
    _check_layout(img)
    h, w = img.shape
    if fused:
        if img.numel() == 0:
            return FUSED_ENTRIES[0]
        sms, smem = limits if limits is not None else card_limits(img.device)
        return FUSED_ENTRIES[0] if band_smem_bytes(h, w, sms) <= smem else FUSED_ENTRIES[1]
    walk = w % 4 == 0 and img.data_ptr() % 16 == 0 and h <= MAX_WALK_H
    return PHASE1_ENTRIES[0] if walk else PHASE1_ENTRIES[1]


def _call(name: str, img: torch.Tensor, *args) -> None:
    """Run C entry point ``name`` on ``img``'s stream and count the launch."""
    fn = _build.function(name, _ARGTYPES[name])
    stream = torch.cuda.current_stream(img.device).cuda_stream
    _build.check(fn(*args, stream), name)
    _build.count(launches, name)


def _launch(name: str, img: torch.Tensor, *, lam: float = 0.5,
            q0sqr: float = 0.05) -> torch.Tensor:
    """Launch entry ``name`` on ``img``: a fused entry returns the step's
    output, a phase-1 entry the coefficient. ``name`` is the routed entry or
    the one of its kind that takes every image (``*_gridstride``,
    ``*_scalar``), which is how the replaced kernels are timed beside their
    successors."""
    _check(img, "srad kernel")
    fused = name in FUSED_ENTRIES
    if not fused and name not in PHASE1_ENTRIES:
        raise ValueError(f"unknown srad entry {name}")
    routed = _route(img, fused=fused)
    if name not in (routed, (FUSED_ENTRIES if fused else PHASE1_ENTRIES)[1]):
        raise ValueError(f"srad entry {name} does not take this image ({routed} does)")
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    h, w = img.shape
    coeff = _coeff_scalars(q0sqr)
    if name == "srad_fused_f32":
        count, rows = bands(h, card_limits(img.device)[0])
        # Each band's first row of c, for the band above (rows padded to 4).
        halo = torch.empty(count, -(-w // 4) * 4, dtype=torch.float32, device=img.device)
        args = (img.data_ptr(), halo.data_ptr(), out.data_ptr(), h, w, rows, *coeff,
                _update_scalar(lam))
    elif fused:
        c = torch.empty_like(img)  # the coefficient, across the grid barrier
        args = (img.data_ptr(), c.data_ptr(), out.data_ptr(), h, w, *coeff,
                _update_scalar(lam))
    else:
        args = (img.data_ptr(), out.data_ptr(), h, w, *coeff)
    _call(name, img, *args)
    return out


def srad_phase1_cuda(img: torch.Tensor, *, q0sqr: float = 0.05) -> torch.Tensor:
    """Launch phase 1 alone: the diffusion coefficient of ``img`` (H, W)."""
    _check(img, "srad_phase1_cuda")
    return _launch(_route(img, fused=False), img, q0sqr=q0sqr)


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
        _call("srad_phase2_f32", img, img.data_ptr(), c.data_ptr(), out.data_ptr(), h, w,
              _update_scalar(lam))
    return out


def srad_step_cuda(
    img: torch.Tensor, *, lam: float = 0.5, q0sqr: float = 0.05, fused: bool = True
) -> torch.Tensor:
    """Launch one SRAD step on ``img`` (H, W): the fused entry
    :func:`_route` names, or the two phases."""
    _check(img, "srad_step_cuda")
    if not fused:
        return srad_phase2_cuda(img, srad_phase1_cuda(img, q0sqr=q0sqr), lam=lam)
    return _launch(_route(img), img, lam=lam, q0sqr=q0sqr)


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
