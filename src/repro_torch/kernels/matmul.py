"""Blocked GEMM kernels (the GEMM and MaxFlops benchmarks, the DNN Connected
layer, Convolution's im2col path): C = A @ B with f32 accumulation, C in A's
dtype.

Counterpart of ``repro/kernels/matmul.py``. The kernels are CUDA C++ for
Hopper (see the note at the top of each source for its bound and design):

- ``matmul_bf16`` (``csrc/matmul_wgmma.cu``): persistent CTAs, TMA loads
  through a 4-stage mbarrier ring, wgmma m64n256k16 on the tensor cores,
  for bf16 operands that TMA can read, 2-D and batched (:func:`_route`);
- ``matmul_f32`` (``csrc/matmul_f32_tma.cu``): true f32 on the FMA pipes,
  persistent CTAs fed by a TMA ring, register-blocked consumers whose
  shared-memory reads are free of bank conflicts, for f32 operands that TMA
  can read, 2-D and batched, at a 128 x 128 or 128 x 256 tile
  (:func:`tune_space`);
- ``matmul_bf16_wmma`` and ``matmul_f32_simt`` (``csrc/matmul.cu``): WMMA
  bf16 fragments with f32 accumulators, and a register-blocked f32 FMA
  GEMM, for every other layout.

The WMMA and SIMT kernels mask ragged edges themselves and read each operand
through its row and column strides, so a transposed view is taken in place,
never copied. A third grid axis runs a batch of products in one launch,
each operand offset by its own batch stride; a stride of 0 broadcasts an
operand, such as Convolution's shared weight. The TMA kernels read a
transposed A (the gemm "tn" specs pass ``a.T``) through its tensor map, and
TMA's zero fill covers their ragged edges; both take the batch as a
coordinate of a 3-D tensor map (a broadcast operand keeps a 2-D map).

- :func:`_route` names the entry a pair of operands goes to, from dtype,
  rank, strides and alignment alone (it runs on CPU tensors too); it
  raises on what no entry takes.
- :func:`matmul_cuda` launches that entry on ``a`` (M, K) or (B, M, K) and
  ``b`` (K, N) or (B, K, N), with ``torch.matmul``'s broadcasting of a
  2-D operand or a batch of 1. It takes CUDA tensors only and raises on
  anything it does not take: another device or dtype, a rank other than 2
  or 3, mismatched shapes or batches, more than 65535 batch entries, an
  operand with no unit stride, or a tile its entry does not compile.
- :func:`matmul_kernel` is the kernel route the dispatch layer calls: a CUDA
  tensor goes to :func:`matmul_cuda`, a CPU tensor to the plain version
  (:func:`matmul_plain`, the ``ref.py`` oracle), the way the reference runs
  its Pallas kernel interpreted off-TPU.
- ``launches`` counts launches per C entry point, batched launches (a 3-D
  result; for ``matmul_bf16`` a batch of more than 1) under their own
  ``*_batched`` key; ``plain_calls`` counts
  kernel-route calls that ran the plain version because their tensors lay
  on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref as matmul_plain

__all__ = [
    "matmul_cuda",
    "matmul_kernel",
    "matmul_plain",
    "tune_space",
    "launches",
    "plain_calls",
]

launches = {
    "matmul_f32": 0, "matmul_f32_batched": 0, "matmul_f32_simt": 0,
    "matmul_f32_simt_batched": 0, "matmul_bf16": 0, "matmul_bf16_batched": 0,
    "matmul_bf16_wmma": 0, "matmul_bf16_wmma_batched": 0,
}
plain_calls = 0

_DTYPES = (torch.float32, torch.bfloat16)
_TILE = {"block_m": 128, "block_n": 128}  # the one tile of the WMMA, SIMT and bf16 TMA kernels
F32_TILES = ({"block_m": 128, "block_n": 128}, {"block_m": 128, "block_n": 256})
MAX_BATCH = 65535  # the WMMA and SIMT kernels' grid z extent
# matmul_f32_simt, matmul_bf16_wmma: a, b, c, batch, M, N, K, sab, sam, sak,
# sbb, sbk, sbn, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + [
    ctypes.c_void_p,
]
# matmul_bf16: a, b, c, batch, M, N, K, a_m_major, lda, sab, ldb, sbb, stream
_TMA_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4 + [
    ctypes.c_void_p,
]
# matmul_f32: a, b, c, batch, M, N, K, a_m_major, lda, sab, ldb, sbb, block_n, stream
_F32_TMA_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4 + [
    ctypes.c_int, ctypes.c_void_p,
]


def tune_space() -> tuple[dict, ...]:
    """Tile candidates (first entry = the kernel's defaults).

    The reference sweeps 128/256 blocks sized for the TPU's 128x128 matrix
    unit. On Hopper a block is one CTA. ``matmul_f32`` compiles 128 x 128
    (64 accumulators a thread) and 128 x 256 (128); the WMMA, SIMT and
    bf16 TMA kernels compile 128 x 128 alone (the bf16 TMA kernel's
    128 x 256 wgmma tile is fixed by its instruction shape and is not a
    tune parameter), so 128 x 256 is taken by f32 operands TMA can read
    and refused by every other entry.
    """
    return tuple(dict(t) for t in F32_TILES)


def _strides(t: torch.Tensor, name: str) -> tuple[int, int]:
    rows, cols = t.shape[-2:]
    rs, cs = t.stride()[-2:]
    if cs == 1 or rs == 1 or rows == 1 or cols == 1:
        return rs, cs
    raise ValueError(
        f"matmul kernel takes row- or column-major operands; {name} has "
        f"shape {tuple(t.shape)} and strides {t.stride()}"
    )


def _tma_layout(t: torch.Tensor, rows_major: bool) -> int | None:
    """The leading stride, in elements, under which TMA reads the matrix (or
    each matrix of the batch) ``t`` row-major (``rows_major``: its columns
    contiguous) or column-major; None where it cannot: a base off 16 bytes,
    no unit stride on the contiguous axis, or a leading stride that is not
    a multiple of 16 bytes. A single row (column) never uses its stride, so
    any 16-byte multiple at least the row's extent serves."""
    rows, cols = t.shape[-2:]
    rs, cs = t.stride()[-2:]
    per16 = 16 // t.element_size()
    n, lead, unit, extent = (rows, rs, cs, cols) if rows_major else (cols, cs, rs, rows)
    if t.data_ptr() % 16 or (unit != 1 and extent != 1):
        return None
    if n == 1:
        return -(-extent // per16) * per16
    return lead if lead > 0 and lead % per16 == 0 else None


def _tma_operands(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int, int, int] | None:
    """(a_m_major, lda, sab, ldb, sbb) for the bf16 TMA kernel, or None:
    bf16, 2-D or batched, with B row-major and A row- or column-major, every
    base 16-byte aligned and every leading and batch stride a multiple of 8
    elements. A batch stride of 0 (a 2-D operand, a batch of 1, an expanded
    batch) broadcasts."""
    if a.dtype != torch.bfloat16:
        return None
    sab, sbb = _batch_stride(a), _batch_stride(b)
    if sab % 8 or sbb % 8:
        return None
    ldb = _tma_layout(b, rows_major=True)
    if ldb is None:
        return None
    for a_m_major in (0, 1):
        lda = _tma_layout(a, rows_major=not a_m_major)
        if lda is not None:
            return a_m_major, lda, sab, ldb, sbb
    return None


def _f32_tma_operands(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int, int, int] | None:
    """(a_m_major, lda, sab, ldb, sbb) for the f32 TMA kernel, or None: f32
    with B row-major, A row- or column-major, every base 16-byte aligned and
    every leading and batch stride a multiple of 4 elements. A batch stride
    of 0 (a 2-D operand, a batch of 1, an expanded batch) broadcasts."""
    if a.dtype != torch.float32:
        return None
    sab, sbb = _batch_stride(a), _batch_stride(b)
    if sab % 4 or sbb % 4:
        return None
    ldb = _tma_layout(b, rows_major=True)
    if ldb is None:
        return None
    for a_m_major in (0, 1):
        lda = _tma_layout(a, rows_major=not a_m_major)
        if lda is not None:
            return a_m_major, lda, sab, ldb, sbb
    return None


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise ValueError(
            f"matmul kernel takes two float32 or two bfloat16 operands, got "
            f"{a.dtype} and {b.dtype}"
        )
    if a.dim() not in (2, 3) or b.dim() not in (2, 3) or a.shape[-1] != b.shape[-2]:
        raise ValueError(
            f"matmul kernel takes (M, K) or (B, M, K) @ (K, N) or (B, K, N), got "
            f"{tuple(a.shape)} @ {tuple(b.shape)}"
        )
    batches = {t.shape[0] for t in (a, b) if t.dim() == 3}
    if len(batches - {1}) > 1:
        raise ValueError(
            f"matmul kernel batches differ: {tuple(a.shape)} @ {tuple(b.shape)}"
        )
    if max(batches, default=1) > MAX_BATCH:
        raise ValueError(
            f"matmul kernel takes at most {MAX_BATCH} batch entries, got {max(batches)}"
        )
    _strides(a, "a")
    _strides(b, "b")


def _route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The C entry point ``a @ b`` goes to: ``matmul_f32`` (TMA) for float32
    operands :func:`_f32_tma_operands` takes, 2-D or batched;
    ``matmul_bf16`` (TMA + wgmma) for bf16, 2-D or batched, whose B is
    row-major, whose A is row- or column-major, whose bases are 16-byte
    aligned and whose leading and batch strides are multiples of 8
    elements;
    ``matmul_f32_simt`` and ``matmul_bf16_wmma`` for every other pair.
    Raises ``ValueError`` on what no entry takes. Looks only at dtype,
    shapes, strides and addresses, so it answers for CPU tensors too."""
    _check(a, b)
    if a.dtype == torch.float32:
        return "matmul_f32" if _f32_tma_operands(a, b) is not None else "matmul_f32_simt"
    return "matmul_bf16" if _tma_operands(a, b) is not None else "matmul_bf16_wmma"


def _batch_stride(t: torch.Tensor) -> int:
    """The stride between batch entries; 0 broadcasts (2-D, or a batch of 1)."""
    return t.stride(0) if t.dim() == 3 and t.shape[0] > 1 else 0


def _check_tile(name: str, block_m: int, block_n: int) -> None:
    """Raise :class:`~repro_torch.kernels.ops.TileRefused` unless entry
    ``name`` compiles the tile (block_m, block_n)."""
    from repro_torch.kernels.ops import TileRefused  # ops imports this module

    tiles = F32_TILES if name == "matmul_f32" else (_TILE,)
    if {"block_m": block_m, "block_n": block_n} not in tiles:
        raise TileRefused(
            f"no compiled tile ({block_m}, {block_n}) for {name}; compiled: {list(tiles)}"
        )


def matmul_cuda(
    a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128, block_n: int = 128
) -> torch.Tensor:
    """Launch the entry :func:`_route` names on ``a`` (M, K) or (B, M, K) and
    ``b`` (K, N) or (B, K, N); the result is (B, M, N) when either operand
    is batched. ``block_m``/``block_n`` name the tile, one the entry
    compiles (:func:`tune_space`); the route and the tile are checked
    before the device, so a CPU tensor reports either first."""
    name = _route(a, b)
    _check_tile(name, block_m, block_n)
    _check_devices(a, b)
    return _launch(name, a, b, block_n=block_n)


def _check_devices(a: torch.Tensor, b: torch.Tensor) -> None:
    if not (a.is_cuda and b.is_cuda):
        raise ValueError(
            f"matmul_cuda needs CUDA tensors, got {a.device} and {b.device}"
        )
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")


# The entry that takes any operands of a dtype: what a comparison times on
# layouts the TMA kernels take.
_ANY_LAYOUT = {torch.float32: "matmul_f32_simt", torch.bfloat16: "matmul_bf16_wmma"}


def _launch(name: str, a: torch.Tensor, b: torch.Tensor, *, block_n: int = 128) -> torch.Tensor:
    """Launch entry ``name``, one that takes these operands: the routed one,
    or the SIMT (f32) or WMMA (bf16) kernel for any pair of its dtype."""
    _check_devices(a, b)
    routed = _route(a, b)
    if name not in (routed, _ANY_LAYOUT[a.dtype]):
        raise ValueError(f"matmul entry {name} does not take these operands ({routed} does)")
    _check_tile(name, 128, block_n)
    batches = {t.shape[0] for t in (a, b) if t.dim() == 3}
    batched = bool(batches)
    batch = max(batches, default=1)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    c = torch.empty((batch, m, n), dtype=a.dtype, device=a.device)
    if not batched:
        c = c[0]
    if batch == 0 or m == 0 or n == 0:
        return c
    if k == 0:
        return c.zero_()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if name == "matmul_bf16":
        a_m_major, lda, sab, ldb, sbb = _tma_operands(a, b)
        fn = _build.function(name, _TMA_ARGTYPES)
        status = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), batch, m, n, k, a_m_major, lda,
                    sab, ldb, sbb, stream)
    elif name == "matmul_f32":
        a_m_major, lda, sab, ldb, sbb = _f32_tma_operands(a, b)
        fn = _build.function(name, _F32_TMA_ARGTYPES)
        status = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), batch, m, n, k, a_m_major, lda,
                    sab, ldb, sbb, block_n, stream)
    else:
        sam, sak = _strides(a, "a")
        sbk, sbn = _strides(b, "b")
        fn = _build.function(name, _ARGTYPES)
        status = fn(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), batch, m, n, k,
            _batch_stride(a), sam, sak, _batch_stride(b), sbk, sbn, stream,
        )
    _build.check(status, name)
    # A batch of 1 on the bf16 TMA kernel is its 2-D product.
    _build.count(launches, name + "_batched" if batched and (name != "matmul_bf16" or batch > 1)
                 else name)
    return c


def matmul_kernel(a: torch.Tensor, b: torch.Tensor, **blocks) -> torch.Tensor:
    """The kernel route: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (the only case it runs)."""
    global plain_calls
    if a.device.type == "cpu" and b.device.type == "cpu":
        plain_calls += 1
        return matmul_plain(a, b)
    return matmul_cuda(a, b, **blocks)
