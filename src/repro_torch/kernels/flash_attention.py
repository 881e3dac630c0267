"""Flash (online-softmax) attention kernels with GQA, causal and
sliding-window masks; the queries sit at the last T of the S key positions,
which covers prefill and cached decode.

Counterpart of ``repro/kernels/flash_attention.py``. Five hand-written CUDA
entry points for Hopper, chosen per call by layout (:func:`_route`); see the
note at the top of each source for its bound and design:

- ``flash_attention_bf16_wgmma`` (``csrc/flash_attention_wgmma.cu``), bf16
  prefill: 128 packed rows of one KV head per CTA, q, k and v brought in by
  TMA (k and v through a 2-stage mbarrier ring), both products on the
  tensor cores by wgmma;
- ``flash_decode_bf16`` (``csrc/flash_decode.cu``), bf16 decode (at most 16
  packed rows per KV head), one launch a call: the visible keys split over
  CTAs, each writing its partial (m, l, acc) in f32, and the last CTA of
  each (batch, KV head) to arrive merging them in its epilogue (arrival
  counters and scratch per (device, stream): :data:`scratch`);
- ``flash_attention_f32`` (``csrc/flash_attention_f32_tma.cu``), f32 whose
  q, k and v TMA can read: K and V by TMA through an mbarrier ring, both
  products register-blocked outer products in true f32 on the CUDA cores;
- ``flash_attention_bf16_simt`` and ``flash_attention_f32_simt``
  (``csrc/flash_attention.cu``): one CTA per 32 packed rows on the CUDA
  cores, for the layouts the other three do not take.

- :func:`flash_attention_cuda` launches the routed entry on q (B, Hq, T, D)
  and k, v (B, Hkv, S, D), float32 or bfloat16, D in :data:`HEAD_DIMS`.
  It reads every operand through its strides and needs only a unit stride
  on the last axis, so transposed activations and a cache sliced to its
  valid length go in as views, never copied. The result is (B, Hq, T, D)
  laid out as (B, T, Hq, D) in memory, so ``out.transpose(1, 2)`` is
  contiguous. It raises on anything else, and on a CPU tensor: a CUDA tensor
  never reaches the plain version.
- :func:`flash_attention_kernel` is the kernel route: CUDA tensors launch,
  CPU tensors run the plain version (:func:`flash_attention_plain`, the
  ``ref.py`` oracle).
- :func:`flash_decode_plain` is the decode kernel's split-and-merge in plain
  PyTorch (the tests hold it against the reference at every split count;
  :func:`flash_decode_combine_plain` is its merge, the kernel's epilogue
  bit for bit); :func:`decode_tiles` and :func:`decode_splits` are the
  kernel's tile range and the wrapper's choice of splits.
- ``launches`` (per C entry point) and ``plain_calls`` count as in
  ``kernels/matmul.py``.

**The meta route.** :func:`flash_attention_kernel` has a third device case
beside CUDA (launch or raise) and the CPU (the plain version): q, k and v
on the ``meta`` device, which is how the dry run (``launch/dryrun.py``)
traces a model at full size without memory. Nothing is built and nothing
launches. The call returns an output of the kernel's shape, dtype and
layout, and adds the kernel's analytic cost to every counter that
:func:`counting_meta` made active: the entry :func:`_route` would take,
4·D operations per visible (query, key) pair (:func:`visible_pairs`) and
the bytes of q, k and v read and the output written once (the bound's
convention of ``PERF.md``). Under autograd :class:`FlashAttentionFunction`
saves q, k and v as on the card, and its backward runs
:func:`attention_bwd_torch` on the meta tensors, traced as the card runs it.
The backward's block loop makes thousands of operations a layer, all of one
shape in every layer of a model, so where the innermost counter has a
``memo(key, fn)`` method the backward goes through it, keyed by the
operands' shapes, strides, dtypes and masks: the counter traces the first
call of a key and may replay its counts for the next.

**Head dims.** Each entry compiles its own set (:data:`ENTRY_HEAD_DIMS`,
each the ``switch (D)`` of its source): the SIMT kernels 8, 16, 32, 64, 80
and 128, the f32 TMA kernel the same but 80, the wgmma and decode kernels 64
and 128. D = 80 (hubert-xlarge's 1280 / 16) is on the SIMT kernels alone:
:func:`_route` sends an f32 call at D = 80 to ``flash_attention_f32_simt``
(the TMA kernel's 32-float boxes and float4 reads of V would need a box of
16 floats there; it is not instantiated), and a bf16 one to
``flash_attention_bf16_simt`` (a tensor-core prefill at D = 80 is
performance work, held for a cell). A D that no entry compiles raises
``ValueError`` before any launch.

**Training.** :class:`FlashAttentionFunction` makes the kernel route
differentiable: its forward is :func:`flash_attention_kernel` (the routed C
entry on the card), its backward :func:`attention_bwd_torch`, the gradient
of the reference's ``sdpa`` (``repro/models/layers.py``) written out in
torch operations, counted in ``backward_calls["attention_bwd_torch"]``. The
reference has no backward kernel either (its training attention is XLA's
gradient of ``sdpa``), so none is written here.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
from torch.profiler import record_function

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref as flash_attention_plain

__all__ = [
    "flash_attention_cuda",
    "flash_attention_kernel",
    "flash_attention_plain",
    "FlashAttentionFunction",
    "counting_meta",
    "visible_pairs",
    "kernel_cost",
    "attention_bwd_torch",
    "flash_decode_cuda",
    "flash_decode_plain",
    "decode_tiles",
    "decode_splits",
    "tune_space",
    "launches",
    "plain_calls",
    "backward_calls",
    "HEAD_DIMS",
    "ENTRY_HEAD_DIMS",
]

launches = {
    "flash_attention_f32": 0, "flash_attention_f32_simt": 0, "flash_attention_bf16_simt": 0,
    "flash_attention_bf16_wgmma": 0, "flash_decode_bf16": 0,
}
plain_calls = 0
# The backward is torch operations, not a C entry: its calls count here.
backward_calls = {"attention_bwd_torch": 0}
# Bytes of one f32 (query rows, keys) block of the backward's scores.
BWD_BLOCK_BYTES = 1 << 26

_DTYPES = (torch.float32, torch.bfloat16)
# Each entry's head dims: the cases of the ``switch (D)`` in its source.
ENTRY_HEAD_DIMS = {
    "flash_attention_f32": (8, 16, 32, 64, 128),
    "flash_attention_f32_simt": (8, 16, 32, 64, 80, 128),
    "flash_attention_bf16_simt": (8, 16, 32, 64, 80, 128),
    "flash_attention_bf16_wgmma": (64, 128),
    "flash_decode_bf16": (64, 128),
}
HEAD_DIMS = tuple(sorted(set().union(*ENTRY_HEAD_DIMS.values())))  # some entry compiles
DECODE_ROWS = 16  # packed rows per KV head (group * T) the decode kernel holds
DECODE_BLOCK_K = 64  # keys per decode tile
MIN_WGMMA_ROWS = 64  # one consumer warpgroup's rows
WAVE_SMS = 132  # an H100 SXM's SMs; the card's own count is used where there is one
_MAX_GRID_YZ = 65535
_INT_MAX = 2**31 - 1
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
]
# The TMA entries (flash_attention_bf16_wgmma, flash_attention_f32).
_TMA_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
]
_SIMT = {torch.float32: "flash_attention_f32_simt", torch.bfloat16: "flash_attention_bf16_simt"}
_DECODE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
]


def tune_space() -> tuple[dict, ...]:
    """Tile candidates (first entry = the kernel's defaults).

    The reference sweeps 128/256-row blocks sized for VMEM. Here the tile
    the op's block parameters name is the prefill kernel's: ``block_q`` the
    packed rows of one CTA (two warpgroups of 64, wgmma's row count) and
    ``block_k`` the keys of one tile in the TMA ring. It is the only tile
    compiled; the decode and SIMT kernels each have one fixed tile. A
    literal, so ``python -m repro_torch.check`` can read it.
    """
    return ({"block_q": 128, "block_k": 128},)


# The prefill kernel's tile, the one the op's block parameters name: 128
# packed rows (two wgmma warpgroups of 64), 128 keys a tile. The decode
# kernel's (16 rows at most, 64 keys), the f32 kernel's (128 rows, or 16 at
# most 16 rows per KV head; 64 keys) and the SIMT kernel's (32 rows, 64
# keys) are fixed.
_TILE = tune_space()[0]


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
        raise ValueError(f"attention kernel takes head dim D in {HEAD_DIMS} (each entry its "
                         f"own: {ENTRY_HEAD_DIMS}), got {d}")
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


def _aligned(x: torch.Tensor) -> bool:
    """Base and strides (over axes of more than one entry) in 16-byte
    multiples: what TMA and 16-byte cp.async need."""
    return x.data_ptr() % 16 == 0 and all(
        st * x.element_size() % 16 == 0 for n, st in zip(x.shape[:3], x.stride()[:3]) if n > 1
    )


def _tma_f32(x: torch.Tensor) -> bool:
    """An f32 operand the f32 kernel reads: 16-byte aligned, and no axis of
    more than one entry with stride 0 (a tensor map's strides are positive)."""
    return _aligned(x) and all(st > 0 for n, st in zip(x.shape[:3], x.stride()[:3]) if n > 1)


def _route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window=None) -> str:
    """The C entry point attention of these operands goes to, by dtype, head
    dim, packed rows per KV head (group * T), and alignment:

    - ``flash_attention_f32`` for float32 with D in its head dims (all but
      80) and q, k and v 16-byte aligned in base and strides (TMA, float4
      loads), ``flash_attention_f32_simt`` for every other float32 call;
    - ``flash_decode_bf16`` for bf16 with D in {64, 128}, at most 16 packed
      rows, and k and v 16-byte aligned;
    - ``flash_attention_bf16_wgmma`` for bf16 with D in {64, 128}, at least
      64 packed rows, a group that divides 128, and q, k and v 16-byte
      aligned (TMA);
    - ``flash_attention_bf16_simt`` for every other bf16 call (D = 80
      among them).

    Every D in :data:`HEAD_DIMS` reaches an entry that compiles it
    (:data:`ENTRY_HEAD_DIMS`). Raises ``ValueError`` on what no entry
    takes. Looks only at shapes, strides and addresses, so it answers for
    CPU tensors too."""
    _check_layout(q, k, v, window)
    d = q.shape[3]
    dims = ENTRY_HEAD_DIMS
    if q.dtype == torch.float32:
        tma = d in dims["flash_attention_f32"] and _tma_f32(q) and _tma_f32(k) and _tma_f32(v)
        return "flash_attention_f32" if tma else "flash_attention_f32_simt"
    _, hq, t, _ = q.shape
    group = hq // k.shape[1]
    rows = group * t
    if _aligned(k) and _aligned(v):
        if rows <= DECODE_ROWS and d in dims["flash_decode_bf16"]:
            return "flash_decode_bf16"
        if (rows >= MIN_WGMMA_ROWS and d in dims["flash_attention_bf16_wgmma"]
                and 128 % group == 0 and _aligned(q)):
            return "flash_attention_bf16_wgmma"
    return "flash_attention_bf16_simt"


def decode_tiles(t: int, s: int, group: int, causal: bool, window: int | None) -> tuple[int, int]:
    """[lo, hi): the 64-key tiles any of the T queries (at positions S - T ..
    S - 1) can see, as the decode kernel computes them."""
    offset = s - t
    n_tiles = -(-s // DECODE_BLOCK_K)
    hi = n_tiles
    if causal:
        last = offset + t - 1
        hi = 0 if last < 0 else min(last // DECODE_BLOCK_K + 1, n_tiles)
    lo = 0
    if window is not None:
        first_key = offset - window + 1
        lo = first_key // DECODE_BLOCK_K if first_key > 0 else 0
    return lo, max(hi, lo)


def decode_splits(b: int, hkv: int, n_tiles: int, sms: int = WAVE_SMS) -> int:
    """How many CTAs share one (batch, KV head)'s tiles: enough that B * Hkv *
    splits reaches two CTAs per SM, never more than the tiles (so every
    split has one), at least 1."""
    want = -(-2 * sms // max(b * hkv, 1))
    return max(1, min(want, n_tiles))


def _split_bounds(lo: int, hi: int, splits: int, i: int) -> tuple[int, int]:
    """Tiles [tb, te) of split ``i``, as the kernel divides [lo, hi)."""
    n = hi - lo
    return lo + i * n // splits, lo + (i + 1) * n // splits


_LOG2E = 1.4426950408889634


def flash_decode_partials_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    splits: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's first launch in plain PyTorch: the visible 64-key
    tiles divided into ``splits`` runs as the kernel divides them, and for
    each run and packed row (position-major over the group's heads) the
    partial (m, l, acc) in f32, m in log2 units of the scaled scores; a run
    that sees no key gives m = -1e30, l = 0, acc = 0. -> part_o (B, Hkv,
    splits, rows, D) and part_ml (B, Hkv, splits, rows, 2), the kernel's
    scratch layout."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = d**-0.5
    lo, hi = decode_tiles(t, s, group, causal, window)
    # Packed rows of each KV head: row r is position r // group of head
    # kv * group + r % group.
    qf = q.float().reshape(b, hkv, group, t, d).transpose(2, 3).reshape(b, hkv, t * group, d)
    q_pos = (torch.arange(t * group, device=q.device) // group)[:, None] + (s - t)
    part_o = qf.new_zeros((b, hkv, splits, t * group, d))
    part_ml = qf.new_zeros((b, hkv, splits, t * group, 2))
    part_ml[..., 0] = -1e30
    for i in range(splits):
        tb, te = _split_bounds(lo, hi, splits, i)
        k_lo, k_hi = tb * DECODE_BLOCK_K, min(te * DECODE_BLOCK_K, s)
        if k_hi <= k_lo:
            continue
        kf, vf = k[:, :, k_lo:k_hi].float(), v[:, :, k_lo:k_hi].float()
        sc = torch.einsum("bkrd,bksd->bkrs", qf, kf) * (scale * _LOG2E)
        k_pos = torch.arange(k_lo, k_hi, device=q.device)[None, :]
        mask = torch.ones((t * group, k_hi - k_lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        sc = sc.masked_fill(~mask, float("-inf"))
        m = sc.amax(-1).clamp_min(-1e30)
        p = torch.exp2(sc - m[..., None])
        part_ml[:, :, i, :, 0] = m
        part_ml[:, :, i, :, 1] = p.sum(-1)
        part_o[:, :, i] = torch.einsum("bkrs,bksd->bkrd", p, vf)
    return part_o, part_ml


def flash_decode_combine_plain(
    part_o: torch.Tensor, part_ml: torch.Tensor, *, hq: int, t: int, dtype: torch.dtype
) -> torch.Tensor:
    """The decode kernel's merge in plain PyTorch: m* = max m_i, w_i =
    2^(m_i - m*), l = sum l_i w_i, o = sum acc_i w_i / max(l, 1e-30), the
    packed rows put back as (B, Hq, T, D) in ``dtype``. The sums run in
    split order, one elementwise product and one sum at a time, each rounded
    on its own: the kernel's epilogue does the same arithmetic in the same
    order (``__fmul_rn``, ``__fadd_rn``), so on the card the two agree bit
    for bit on the same partials."""
    b, hkv, splits, rows, d = part_o.shape
    m = part_ml[..., 0]
    w = torch.exp2(m - m.amax(2, keepdim=True))
    l_sum = torch.zeros_like(m[:, :, 0])
    o = torch.zeros_like(part_o[:, :, 0])
    for i in range(splits):
        l_sum = l_sum + part_ml[:, :, i, :, 1] * w[:, :, i]
        o = o + part_o[:, :, i] * w[:, :, i, :, None]
    o = o / l_sum.clamp_min(1e-30)[..., None]
    group = hq // hkv
    return o.reshape(b, hkv, t, group, d).transpose(2, 3).reshape(b, hq, t, d).to(dtype)


def flash_decode_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    splits: int = 1,
) -> torch.Tensor:
    """The decode pair's arithmetic in plain PyTorch, split by split
    (:func:`flash_decode_partials_plain`) and merged
    (:func:`flash_decode_combine_plain`). Used by the tests; any T."""
    part_o, part_ml = flash_decode_partials_plain(q, k, v, causal=causal, window=window,
                                                  scale=scale, splits=splits)
    return flash_decode_combine_plain(part_o, part_ml, hq=q.shape[1], t=q.shape[2],
                                      dtype=q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _strides_arg(*tensors: torch.Tensor, fill: int = 0) -> ctypes.Array:
    """Element strides of each tensor's first three axes; with ``fill``, an
    axis of one entry gets ``fill`` (its stride is never used, and TMA wants
    a 16-byte multiple)."""
    out = []
    for x in tensors:
        out += [st if n > 1 or not fill else fill for n, st in zip(x.shape[:3], x.stride()[:3])]
    return (ctypes.c_longlong * len(out))(*out)


def _check_devices(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(
            f"flash_attention_cuda needs CUDA tensors, got {q.device}, {k.device}, {v.device}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")


def _window_arg(window: int | None, s: int, t: int) -> int:
    # A window at least S + T wide masks nothing; clamping keeps it an int.
    return -1 if window is None else min(int(window), s + t + 1)


def decode_scratch_sizes(b: int, hq: int, hkv: int, t: int, d: int, splits: int) -> tuple[int, int]:
    """(int32 counters, f32 scratch floats) one decode launch needs: one
    arrival counter per (batch, KV head), and part_o then part_ml, B * Hq * T
    * splits * (D + 2) floats; none of either at one split."""
    if splits <= 1:
        return 0, 0
    return b * hkv, b * hq * t * splits * (d + 2)


class DecodeScratch:
    """The decode kernel's arrival counters and partials scratch, one pair
    per (device, stream), grown when a call needs more and kept.

    Launches on one stream run in order, so they can share a pair: each
    launch leaves its counters at 0 as it found them, and the next one
    overwrites the partials only after the last finished reading them. Two
    decode calls in flight on two streams must never share counters, hence
    the key. A call under CUDA-graph capture finds the pair of the capture
    stream; the graph keeps those addresses, so two replays of it in flight
    at once on two streams would share them."""

    def __init__(self) -> None:
        self._pairs: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    def get(self, device: torch.device, stream: int, counters: int,
            floats: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(counters, scratch) of ``device`` and ``stream`` (its handle), at
        least ``counters`` int32 zeros and ``floats`` f32 entries."""
        key = self._key(device, stream)
        cnt, part = self._pairs.get(key, (None, None))
        if cnt is None or cnt.numel() < counters:
            cnt = torch.zeros(max(counters, 1), dtype=torch.int32, device=device)
        if part is None or part.numel() < floats:
            part = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
        self._pairs[key] = (cnt, part)
        return cnt, part

    def counters(self, device: torch.device, stream: int) -> torch.Tensor | None:
        """The counters of ``device`` and ``stream``, None before their first use."""
        return self._pairs.get(self._key(device, stream), (None, None))[0]

    @staticmethod
    def _key(device: torch.device, stream: int) -> tuple:
        # torch.device("cuda") names the current card, as a tensor's device does by number.
        index = device.index
        if index is None and device.type == "cuda":
            index = torch.cuda.current_device()
        return device.type, index, stream


scratch = DecodeScratch()


def _decode_launch(q, k, v, causal, window, scale, splits, part, counters, out, stream) -> None:
    """One launch of ``flash_decode_bf16``: into ``out`` when it is given
    (the merge in the epilogue; ``part`` and ``counters`` used only at more
    than one split), else the partials into ``part`` (part_o, then part_ml).
    Operands already routed and checked, S >= 1."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    name = "flash_decode_bf16"
    status = _build.function(name, _DECODE_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if out is None else out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), b, hq, hkv, t, s, d,
        int(bool(causal)), _window_arg(window, s, t),
        float(d**-0.5 if scale is None else scale),
        _strides_arg(q, k, v, q if out is None else out), splits, stream,
    )
    _build.check(status, name)
    _build.count(launches, name)


def _decode(q, k, v, causal, window, scale, splits=None):
    """One decode launch into a new output (operands already checked; S >=
    1); ``splits`` None picks :func:`decode_splits` for the card. Its
    counters and scratch are the (device, stream) pair of :data:`scratch`."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if splits is None:
        lo, hi = decode_tiles(t, s, hq // hkv, causal, window)
        splits = decode_splits(b, hkv, hi - lo, _sm_count(q.device.index or 0))
    out = _empty_out(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = part = None
    if splits > 1:
        counters, part = scratch.get(q.device, stream,
                                     *decode_scratch_sizes(b, hq, hkv, t, d, splits))
    _decode_launch(q, k, v, causal, window, scale, splits, part, counters, out, stream)
    return out


def _check_decode(q, k, v, window, splits) -> None:
    name = _route(q, k, v, window)
    if name != "flash_decode_bf16":
        raise ValueError(f"flash_decode_bf16 does not take these operands ({name} does)")
    _check_devices(q, k, v)
    if (splits is not None and splits < 1) or k.shape[2] < 1 or q.numel() == 0:
        raise ValueError(
            f"decode needs splits >= 1, S >= 1 and queries, got {splits}, {tuple(k.shape)}, "
            f"{tuple(q.shape)}"
        )


def flash_decode_partials_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    splits: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel alone (``flash_decode_bf16``) at ``splits`` splits
    (any count from 1, more than the visible tiles included), on operands
    :func:`_route` sends to it, with S >= 1: part_o and part_ml as
    :func:`flash_decode_partials_plain` lays them out."""
    _check_decode(q, k, v, window, splits)
    b, hq, t, d = q.shape
    hkv = k.shape[1]
    part = torch.empty(b * hq * t * splits * (d + 2), dtype=torch.float32, device=q.device)
    _decode_launch(q, k, v, causal, window, scale, splits, part, None, None,
                   torch.cuda.current_stream(q.device).cuda_stream)
    rows = hq // hkv * t
    n = b * hkv * splits * rows
    return (part[: n * d].view(b, hkv, splits, rows, d),
            part[n * d:].view(b, hkv, splits, rows, 2))


def _empty_out(q: torch.Tensor) -> torch.Tensor:
    """(B, Hq, T, D) laid out as (B, T, Hq, D), so the model's reshape is free."""
    b, hq, t, d = q.shape
    return torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def flash_decode_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """The decode kernel, one launch, the counterpart of
    :func:`flash_decode_plain`: ``splits`` None picks :func:`decode_splits`
    for the card, as :func:`flash_attention_cuda` does."""
    _check_decode(q, k, v, window, splits)
    return _decode(q, k, v, causal, window, scale, splits)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Launch the entry :func:`_route` names: attention of q (B, Hq, T, D)
    over k, v (B, Hkv, S, D); returns (B, Hq, T, D) in q's dtype.
    ``block_q``/``block_k`` name the prefill kernel's tile, the one there
    is a choice of (:func:`tune_space`)."""
    name = _route(q, k, v, window)
    if {"block_q": block_q, "block_k": block_k} != _TILE:
        raise ValueError(f"no compiled tile ({block_q}, {block_k}); compiled: {_TILE}")
    _check_devices(q, k, v)
    return _run(name, q, k, v, causal, window, scale)


def _launch(name: str, q, k, v, *, causal=False, window=None, scale=None) -> torch.Tensor:
    """Launch entry ``name``, one that takes these operands: the routed one,
    or the SIMT kernel of their dtype, which takes any (which is how a
    comparison times it at the shapes its successors take)."""
    routed = _route(q, k, v, window)
    if name not in (routed, _SIMT[q.dtype]):
        raise ValueError(f"attention entry {name} does not take these operands ({routed} does)")
    _check_devices(q, k, v)
    return _run(name, q, k, v, causal, window, scale)


def _run(name: str, q, k, v, causal, window, scale) -> torch.Tensor:
    """Launch entry ``name`` on operands already routed and checked."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if name == "flash_decode_bf16" and s > 0 and q.numel() > 0:
        return _decode(q, k, v, causal, window, scale)
    out = _empty_out(q)
    if out.numel() == 0:
        return out
    if s == 0:
        return out.zero_()
    if scale is None:
        scale = d**-0.5
    win = _window_arg(window, s, t)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if name in ("flash_attention_bf16_wgmma", "flash_attention_f32"):
        fn = _build.function(name, _TMA_ARGTYPES)
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, t, s, d,
            int(bool(causal)), win, float(scale), _strides_arg(q, k, v, out, fill=d), stream,
        )
    else:
        strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
        # Tile loads go 16 bytes at a time where every k and v row starts on a
        # 16-byte boundary; elementwise otherwise.
        vec = int(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
                  and all(st * q.element_size() % 16 == 0 for st in strides[3:9]))
        fn = _build.function(name, _ARGTYPES)
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, t, s, d,
            int(bool(causal)), win, float(scale), (ctypes.c_longlong * 12)(*strides), vec,
            stream,
        )
    _build.check(status, name)
    _build.count(launches, name)
    return out


# The meta route's active counters, each with a ``kernel(entry, flops,
# nbytes, dtype)`` method. A plain list, not a context variable: autograd
# runs a backward on meta tensors on the calling thread, and the dry run
# traces one cell at a time.
_META_COUNTERS: list = []


@contextlib.contextmanager
def counting_meta(counter):
    """Make ``counter`` receive the cost of every attention call on meta
    tensors until the block exits."""
    _META_COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _META_COUNTERS.remove(counter)


def visible_pairs(t: int, s: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the masks leave visible, the T queries at the last
    T of S key positions: the work one (batch, query head) needs."""
    import numpy as np

    q_pos = np.arange(s - t, s, dtype=np.int64)
    hi = np.minimum(q_pos + 1, s) if causal else np.full_like(q_pos, s)
    lo = np.maximum(q_pos - window + 1, 0) if window is not None else np.zeros_like(q_pos)
    return int(np.maximum(hi - lo, 0).sum())


def kernel_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                window: int | None) -> tuple[float, float]:
    """(operations, bytes) of one attention call: 4·D a visible pair (QKᵀ
    and PV) over every batch row and query head; q, k and v read and the
    output written once."""
    b, hq, t, d = q.shape
    pairs = b * hq * visible_pairs(t, k.shape[2], causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return 4.0 * d * pairs, float(nbytes)


def _meta_route(q, k, v, causal, window) -> torch.Tensor:
    """The kernel route on meta tensors: the routed entry's output shape and
    layout, its cost to the active counters, nothing launched."""
    if not (q.is_meta and k.is_meta and v.is_meta):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    name = _route(q, k, v, window)
    flops, nbytes = kernel_cost(q, k, v, causal, window)
    for counter in _META_COUNTERS:
        counter.kernel(name, flops, nbytes, q.dtype)
    return _empty_out(q)


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
    for CPU tensors (the only case it runs), the meta route for meta
    tensors (shape and cost only)."""
    global plain_calls
    if q.device.type == "meta":
        return _meta_route(q, k, v, causal, window)
    if q.device.type == "cpu":
        plain_calls += 1
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale, **blocks)


# -- the backward ---------------------------------------------------------------


def attention_bwd_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention of q (B, Hq, T, D) over k, v (B, Hkv, S, D)
    for the output's gradient ``dout`` (B, Hq, T, D): the gradient of the
    reference's ``sdpa``, in f32, each cast to its input's dtype.

    One block of query rows at a time, each block's (rows, keys) f32 scores
    at most :data:`BWD_BLOCK_BYTES`, over the keys some row of the block
    sees (a causal or window mask cuts the rest). A block recomputes
    S = scale·QKᵀ under the mask and P = softmax(S), then dV += PᵀdO,
    dP = dO·Vᵀ, dS = P∘(dP − rowsum(P∘dP)), dQ = scale·dS·K, dK +=
    scale·dSᵀ·Q, the GQA group summed into its KV head. The rowsum is
    flash attention's rowsum(dO∘O), equal in exact arithmetic and the
    softmax's own gradient: the block holds whole rows of P, so it needs no
    saved output and carries none of its rounding to bf16. A row that sees
    no key has P = 0 and gradient 0.
    """
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    qf = q.float().reshape(b, hkv, g, t, d)
    dof = dout.float().reshape(b, hkv, g, t, d)
    kf, vf = k.float(), v.float()
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    rows = max(1, BWD_BLOCK_BYTES // max(1, b * hq * s * 4))
    for t0 in range(0, t, rows):
        t1 = min(t, t0 + rows)
        # Absolute positions: the queries sit at the last T of the S keys.
        lo, hi = 0, s
        if causal:
            hi = min(s, t1 + s - t)
        if window is not None:
            lo = max(0, t0 + s - t - window + 1)
        if hi <= lo:
            continue
        q_pos = torch.arange(t0, t1, device=q.device)[:, None] + (s - t)
        k_pos = torch.arange(lo, hi, device=q.device)[None, :]
        mask = torch.ones((t1 - t0, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        qb, dob = qf[:, :, :, t0:t1], dof[:, :, :, t0:t1]
        kb, vb = kf[:, :, lo:hi], vf[:, :, lo:hi]
        sc = torch.einsum("bkgtd,bksd->bkgts", qb, kb) * scale
        sc = sc.masked_fill(~mask, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        p = torch.where(mask.any(dim=-1)[:, None], p, 0.0)
        dv[:, :, lo:hi] += torch.einsum("bkgts,bkgtd->bksd", p, dob)
        dp = torch.einsum("bkgtd,bksd->bkgts", dob, vb)
        ds = p * (dp - torch.sum(p * dp, dim=-1, keepdim=True))
        dq[:, :, :, t0:t1] = torch.einsum("bkgts,bksd->bkgtd", ds, kb) * scale
        dk[:, :, lo:hi] += torch.einsum("bkgts,bkgtd->bksd", ds, qb) * scale
    return (dq.reshape(b, hq, t, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class FlashAttentionFunction(torch.autograd.Function):
    """Attention through the kernel route, differentiable: the forward is
    :func:`flash_attention_kernel` (the routed C entry for CUDA tensors, the
    plain version for CPU ones, the meta route for meta ones), the backward
    :func:`attention_bwd_torch`.
    ``ops.attention`` applies it only where a gradient is wanted."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, blocks):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return flash_attention_kernel(q, k, v, causal=causal, window=window, scale=scale,
                                      **dict(blocks))

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors

        def run():
            return attention_bwd_torch(q, k, v, dout, **ctx.opts)

        with record_function("attention_bwd_torch"):
            memo = getattr(_META_COUNTERS[-1], "memo", None) if (
                q.is_meta and _META_COUNTERS) else None
            if memo is None:
                dq, dk, dv = run()
            else:
                key = ("attention_bwd_torch", tuple(ctx.opts.items()),
                       *((tuple(t.shape), t.stride(), t.dtype) for t in (q, k, v, dout)))
                dq, dk, dv = memo(key, run)
        _build.count(backward_calls, "attention_bwd_torch")
        return dq, dk, dv, None, None, None, None
