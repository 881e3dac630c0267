"""Level 2: GPUDWT — 2-D discrete wavelet transform (image compression).

Counterpart of ``repro/bench/level2/dwt2d.py``: one level of the integer
5/3 (lossless JPEG2000) or the floating 9/7 (lossy) wavelet, forward, by
the lifting scheme: separable row and column passes of shift-add steps,
slicing and concatenation on the card. Validation is the round trip,
inverse(forward(x)) within the reference's ``rtol=1e-4, atol=1e-3``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register

# CDF 9/7 lifting coefficients (JPEG2000).
_A1, _A2, _A3, _A4 = -1.586134342, -0.05298011854, 0.8829110762, 0.4435068522
_K = 1.149604398


def _lift_1d(x, mode: str, inverse: bool):
    """Lifting along the last axis (even length). Returns (lo, hi)."""
    even, odd = x[..., 0::2], x[..., 1::2]

    def predict(e, o, coef):
        e_next = torch.cat([e[..., 1:], e[..., -1:]], dim=-1)
        return o + coef * (e + e_next)

    def update(e, o, coef):
        o_prev = torch.cat([o[..., :1], o[..., :-1]], dim=-1)
        return e + coef * (o + o_prev)

    if mode == "53":
        if not inverse:
            d = predict(even, odd, -0.5)
            s = update(even, d, 0.25)
            return s, d
        s, d = even, odd
        e = update(s, d, -0.25)
        o = predict(e, d, 0.5)
        return e, o
    if not inverse:
        d = predict(even, odd, _A1)
        s = update(even, d, _A2)
        d = predict(s, d, _A3)
        s = update(s, d, _A4)
        return s * _K, d / _K
    s, d = even / _K, odd * _K
    s = update(s, d, -_A4)
    d = predict(s, d, -_A3)
    s = update(s, d, -_A2)
    d = predict(s, d, -_A1)
    return s, d


def _interleave(lo, hi):
    return torch.stack([lo, hi], dim=-1).reshape(*lo.shape[:-1], lo.shape[-1] * 2)


def _lift_1d_inv_pair(x, mode):
    h = x.shape[-1] // 2
    return _lift_1d(_interleave(x[..., :h], x[..., h:]), mode, True)


def dwt2d(x: torch.Tensor, mode: str = "97", inverse: bool = False) -> torch.Tensor:
    """One-level separable 2-D DWT. x: (..., H, W), H and W even."""
    if not inverse:
        x = torch.cat(_lift_1d(x, mode, False), dim=-1)  # rows
        x = x.transpose(-1, -2)
        x = torch.cat(_lift_1d(x, mode, False), dim=-1)  # cols
        return x.transpose(-1, -2)
    x = x.transpose(-1, -2)
    x = _interleave(*_lift_1d_inv_pair(x, mode))
    x = x.transpose(-1, -2)
    return _interleave(*_lift_1d_inv_pair(x, mode))


def _make(n: int, mode: str) -> Workload:
    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        img = rng.random((n, n), dtype=np.float32) * np.float32(255.0)
        if mode == "53":
            img = np.round(img)
        return (torch.from_numpy(img),)

    def fn(img):
        return dwt2d(img, mode=mode, inverse=False)

    def validate(out, args):
        (img,) = args
        rec = dwt2d(out, mode=mode, inverse=True)
        torch.testing.assert_close(rec, img, rtol=1e-4, atol=1e-3)

    return Workload(
        name=f"dwt2d.{mode}.{n}x{n}",
        fn=fn,
        make_inputs=make_inputs,
        flops=float(n * n * (14 if mode == "97" else 5)),
        bytes_moved=float(n * n * 4 * 2),
        validate=validate,
        # Opt out, as the reference: the column pass mixes rows.
        batch_dims=None,
    )


for _mode in ("53", "97"):
    register(
        BenchmarkSpec(
            name=f"dwt2d_{_mode}",
            level=2,
            dwarf="Spectral method",
            domain="Image processing",
            cuda_feature=None,
            gpu_feature="lifting steps as slicing and concatenation",
            presets=geometric_presets(
                {"n": 256, "mode": _mode}, scale_keys={"n": 2.0}, round_to=16
            ),
            build=lambda n, mode: _make(n, mode),
        )
    )
