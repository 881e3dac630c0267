"""Flash (online-softmax) attention kernel with GQA, causal and sliding-window
masks; the queries sit at the last T of the S key positions, which covers
prefill and cached decode.

Counterpart of ``repro/kernels/flash_attention.py``. The kernel is CUDA C++
for Hopper in ``csrc/flash_attention.cu`` (see the note at its top for its
bound and design): one CTA per 32 query rows of one KV head (the rows of its
query heads, position-major), K and V tiles of 64 keys in shared memory in
the input dtype, scores, max and sum in f32, and key-tile bounds from the
causal and window masks as in the reference.

- :func:`flash_attention_cuda` launches the kernel on q (B, Hq, T, D) and
  k, v (B, Hkv, S, D), float32 or bfloat16, D in {8, 16, 32, 64, 128}. It
  reads every operand through its strides and needs only a unit stride on
  the last axis, so transposed activations and a cache sliced to its valid
  length go in as views, never copied. The result is (B, Hq, T, D) laid out
  as (B, T, Hq, D) in memory, so ``out.transpose(1, 2)`` is contiguous. It
  raises on anything else, and on a CPU tensor.
- :func:`flash_attention_kernel` is the kernel route: CUDA tensors launch,
  CPU tensors run the plain version (:func:`flash_attention_plain`, the
  ``ref.py`` oracle).
- ``launches`` (per C entry point) and ``plain_calls`` count as in
  ``kernels/matmul.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref as flash_attention_plain

__all__ = [
    "flash_attention_cuda",
    "flash_attention_kernel",
    "flash_attention_plain",
    "tune_space",
    "launches",
    "plain_calls",
    "HEAD_DIMS",
]

launches = {"flash_attention_f32": 0, "flash_attention_bf16": 0}
plain_calls = 0

_DTYPES = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_TILE = {"block_q": 32, "block_k": 64}  # the one tile csrc compiles
HEAD_DIMS = (8, 16, 32, 64, 128)  # the head dims csrc instantiates
_MAX_GRID_YZ = 65535
_INT_MAX = 2**31 - 1
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
]


def tune_space() -> tuple[dict, ...]:
    """Tile candidates (first entry = the kernel's defaults).

    The reference sweeps 128/256-row blocks sized for VMEM. Here ``block_q``
    counts the rows of one CTA (4 warps of 8 rows, taken from all query heads
    of one KV head) and ``block_k`` the keys of one shared-memory tile. It
    is the only tile compiled until a tune stage has a shape where another
    one wins.
    """
    return (dict(_TILE),)


def _check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"attention kernel takes q (B, Hq, T, D) and k, v (B, Hkv, S, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, hq, t, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"attention kernel: k {tuple(k.shape)} and v {tuple(v.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    hkv = k.shape[1]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dim D in {HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"attention kernel takes float32 or bfloat16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(
                f"attention kernel needs a unit stride on the last axis; {name} has "
                f"shape {tuple(x.shape)} and strides {x.stride()}"
            )
    if b > _MAX_GRID_YZ or hkv > _MAX_GRID_YZ or (hq // hkv) * t > _INT_MAX - 64:
        raise ValueError(f"attention kernel grid too large for {tuple(q.shape)}")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    block_q: int = 32,
    block_k: int = 64,
) -> torch.Tensor:
    """Launch the CUDA kernel: attention of q (B, Hq, T, D) over k, v
    (B, Hkv, S, D); returns (B, Hq, T, D) in q's dtype."""
    _check_layout(q, k, v, window)
    if {"block_q": block_q, "block_k": block_k} != _TILE:
        raise ValueError(f"no compiled tile ({block_q}, {block_k}); compiled: {_TILE}")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(
            f"flash_attention_cuda needs CUDA tensors, got {q.device}, {k.device}, {v.device}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    out = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    if s == 0:
        return out.zero_()
    if scale is None:
        scale = d**-0.5
    # A window at least S + T wide masks nothing; clamping keeps it an int.
    win = -1 if window is None else min(int(window), s + t + 1)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    # Tile loads go 16 bytes at a time where every k and v row starts on a
    # 16-byte boundary; elementwise otherwise.
    vec = int(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
              and all(st * q.element_size() % 16 == 0 for st in strides[3:9]))
    name = _DTYPES[q.dtype]
    fn = _build.function(name, _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, t, s, d,
        int(bool(causal)), win, float(scale), (ctypes.c_longlong * 12)(*strides), vec, stream,
    )
    _build.check(status, name)
    launches[name] += 1
    return out


def flash_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    **blocks,
) -> torch.Tensor:
    """The kernel route: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (the only case it runs)."""
    global plain_calls
    if q.device.type == "cpu":
        plain_calls += 1
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale, **blocks)
