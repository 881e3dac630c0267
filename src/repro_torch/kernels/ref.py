"""Plain PyTorch oracles for every kernel of the suite.

Each ``*_ref`` is the semantic ground truth that its hand-written kernel is
held against: straightforward, un-tiled tensor code that computes in f32 and
casts back to the input's dtype at the end. Counterpart of
``repro/kernels/ref.py``, function for function, including its details:
attention's fully masked rows are zeros (not NaN), LRN's ``alpha`` is not
divided by ``size``, SRAD clamps at the image edges, and the key-value sort
is stable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "matmul_ref",
    "attention_ref",
    "softmax_ref",
    "lrn_ref",
    "avgpool_ref",
    "srad_step_ref",
    "prefix_scan_ref",
    "sort_kv_ref",
]


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with f32 accumulation, cast back to A's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def attention_ref(
    q: torch.Tensor,  # (B, Hq, T, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    return_lse: bool = False,
):
    """Dense GQA attention; queries sit at the last T of the S key positions.

    ``window`` is sliding-window attention: the query at absolute position p
    attends to keys in (p - window, p]. ``return_lse``: -> (out, lse), lse
    (B, Hq, T) f32 each row's log-sum-exp of its masked scaled scores
    (natural log; -inf for a row that sees no key), from the same f32
    scores; ``out`` is the same either way.
    """
    _, hq, t, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    if scale is None:
        scale = d**-0.5
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), kx) * scale
    q_pos = torch.arange(t, device=q.device)[:, None] + (s_len - t)
    k_pos = torch.arange(s_len, device=q.device)[None, :]
    mask = torch.ones((t, s_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    # A fully masked row is NaN after softmax; define it as zeros.
    p = torch.where(mask.any(dim=-1)[None, None, :, None], p, 0.0)
    out = torch.einsum("bhts,bhsd->bhtd", p, vx).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def softmax_ref(x: torch.Tensor) -> torch.Tensor:
    """Row softmax over the last axis, f32 inside."""
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def lrn_ref(
    x: torch.Tensor,  # (N, C, H, W)
    *,
    size: int = 5,
    alpha: float = 1e-4,
    beta: float = 0.75,
    k: float = 2.0,
) -> torch.Tensor:
    """AlexNet local response normalisation across channels (paper eq. 3)."""
    xf = x.float()
    half = size // 2
    c = x.shape[1]
    padded = F.pad(xf * xf, (0, 0, 0, 0, half, half))
    win = sum(padded[:, i : i + c] for i in range(size))
    return (xf / torch.pow(k + alpha * win, beta)).to(x.dtype)


def avgpool_ref(x: torch.Tensor, *, ksize: int = 2) -> torch.Tensor:
    """Non-overlapping (stride == ksize) average pooling on (N, C, H, W)."""
    n, c, h, w = x.shape
    if h % ksize or w % ksize:
        raise ValueError(f"H={h} and W={w} must divide by ksize={ksize}")
    xf = x.float().reshape(n, c, h // ksize, ksize, w // ksize, ksize)
    return xf.mean(dim=(3, 5)).to(x.dtype)


def _srad_diffs(img: torch.Tensor):
    """Clamped 4-neighbour differences (north, south, west, east)."""
    north = torch.cat([img[:1], img[:-1]], dim=0)
    south = torch.cat([img[1:], img[-1:]], dim=0)
    west = torch.cat([img[:, :1], img[:, :-1]], dim=1)
    east = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    return north - img, south - img, west - img, east - img


def srad_phase1_ref(img: torch.Tensor, *, q0sqr: float = 0.05) -> torch.Tensor:
    """SRAD phase 1: the diffusion coefficient (f32) from clamped
    4-neighbour gradients, clipped to [0, 1]."""
    img = img.float()
    d_n, d_s, d_w, d_e = _srad_diffs(img)
    g2 = (d_n * d_n + d_s * d_s + d_w * d_w + d_e * d_e) / (img * img)
    lap = (d_n + d_s + d_w + d_e) / img
    num = 0.5 * g2 - 0.0625 * lap * lap
    den = 1.0 + 0.25 * lap
    qsqr = num / (den * den)
    c = 1.0 / (1.0 + (qsqr - q0sqr) / (q0sqr * (1.0 + q0sqr)))
    return c.clamp(0.0, 1.0)


def srad_phase2_ref(img: torch.Tensor, c: torch.Tensor, *, lam: float = 0.5) -> torch.Tensor:
    """SRAD phase 2: the divergence update by the coefficient ``c``, with c at
    the south and east neighbours clamped at the edges."""
    imgf, c = img.float(), c.float()
    d_n, d_s, d_w, d_e = _srad_diffs(imgf)
    c_s = torch.cat([c[1:], c[-1:]], dim=0)  # c at the south neighbour
    c_e = torch.cat([c[:, 1:], c[:, -1:]], dim=1)  # c at the east neighbour
    div = c * d_n + c_s * d_s + c * d_w + c_e * d_e
    return (imgf + 0.25 * lam * div).to(img.dtype)


def srad_step_ref(
    img: torch.Tensor, *, lam: float = 0.5, q0sqr: float = 0.05
) -> torch.Tensor:
    """One SRAD diffusion step (phases 1 and 2) on a 2-D image."""
    return srad_phase2_ref(img, srad_phase1_ref(img, q0sqr=q0sqr), lam=lam)


def prefix_scan_ref(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, f32 accumulation."""
    return torch.cumsum(x.float(), dim=-1).to(x.dtype)


def sort_kv_ref(
    keys: torch.Tensor, values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ascending key sort carrying values; equal keys keep their order."""
    sorted_keys, order = torch.sort(keys, dim=-1, stable=True)
    return sorted_keys, torch.gather(values, -1, order)
