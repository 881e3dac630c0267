"""Core transformer layers: RMSNorm, RoPE and M-RoPE, GQA attention, SwiGLU.

Counterpart of ``repro/models/layers.py``, function for function, in its
functional style: ``init_*(generator, cfg)`` builds a dict of tensors and an
``apply`` function takes it (a dict or an ``nn.ParameterDict``). Weights keep
the reference's (d_in, d_out) layout, so ``x @ w`` is the same product as
the reference's and ``convert.model_state_from_reference`` copies them
without a transpose.

Numerics as in the reference: parameters and activations in ``cfg.dtype``
(bf16 for the published configs), normalisation statistics, RoPE and
attention in f32.

Attention goes through ``kernels.ops.attention``: the hand-written flash
kernel for CUDA tensors, its plain version on the CPU. The reference's
XLA-only attention knobs (``attn_chunk``, ``score_dtype``, ``unroll_inner``)
have no counterpart here: a config that sets one away from its default is
refused, never quietly run another way. M-RoPE (Qwen2-VL's multimodal
positions) follows the reference's section rule (:func:`rope_angles`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig

__all__ = [
    "dtype_of",
    "check_supported",
    "rms_norm",
    "init_dense",
    "init_attention",
    "project_qkv",
    "apply_attention",
    "init_mlp",
    "apply_mlp",
    "mrope_sections",
    "rope_angles",
    "apply_rope",
    "is_dtensor",
    "replicated_like",
    "whole_sequence",
    "split_heads",
    "merge_heads",
    "on_rows",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    try:
        return _DTYPES[cfg.dtype]
    except KeyError:
        raise ValueError(f"dtype {cfg.dtype!r} not one of {sorted(_DTYPES)}") from None


def check_supported(cfg: ArchConfig) -> None:
    """Refuse what the port's attention does not run: the reference's XLA
    knobs away from their defaults."""
    knobs = {"attn_chunk": (cfg.attn_chunk, 0), "score_dtype": (cfg.score_dtype, "float32"),
             "unroll_inner": (cfg.unroll_inner, False)}
    set_knobs = {k: v for k, (v, default) in knobs.items() if v != default}
    if set_knobs:
        raise ValueError(
            f"{cfg.name}: {set_knobs} tune the reference's XLA attention; the port's "
            "attention is the flash kernel and has no such knob"
        )


def init_dense(generator: torch.Generator | None, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    """``scale`` times a normal truncated to [-2, 2], on the generator's
    device, in ``dtype``. Without a generator the tensor is on the meta
    device: its shape and dtype only."""
    scale = 0.02 if scale is None else scale
    device = "meta" if generator is None else generator.device
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=generator)
    return w.mul_(scale).to(dtype)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (one type check for a plain tensor)."""
    if type(t) is torch.Tensor or not isinstance(t, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor made inside the model from shapes (positions, a
    frequency table, a zero state, a mask), replicated on ``ref``'s mesh
    where ``ref`` is a DTensor, so that it meets ``ref``'s DTensors as one;
    else ``t`` itself. Every rank makes the same ``t``."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim, run_check=False)


def whole_sequence(x: torch.Tensor) -> torch.Tensor:
    """A DTensor activation with every dim but the batch (dim 0) gathered
    (a ``Partial`` one reduced): the sequence a mixer's or an FFN's
    projections read, as Megatron's sequence parallelism gathers it before
    its column-parallel products (and GSPMD against the reference's weight
    specs), and the mixer's or the FFN's output before it joins the
    residual stream. The products then see rows sharded on the batch alone,
    forward and backward (a redistribution's gradient takes its input's
    layout), and weights sharded on their own dims. A plain tensor as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    pl = tuple(p if p.is_shard() and p.dim % x.dim() == 0 else Replicate()
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """x (..., n·hd) viewed as (..., n, hd). A DTensor whose last dim is
    sharded over mesh dims that do not divide ``n`` (8 KV heads on a model
    axis of 16: each rank holds half a head) has that dim gathered over
    them first, since a part of a head cannot be viewed as heads."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        last = [i for i, p in enumerate(x.placements)
                if p.is_shard() and p.dim % x.dim() == x.dim() - 1]
        if n % math.prod(x.device_mesh.size(i) for i in last):
            x = x.redistribute(x.device_mesh, tuple(Replicate() if i in last else p
                                                    for i, p in enumerate(x.placements)))
    return x.reshape(*x.shape[:-1], n, hd)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """x (..., n, hd) viewed as (..., n·hd). A DTensor held whole over a mesh
    dim that does not divide ``n`` (the heads of an attention that gathered
    them: 12 on a model axis of 16) is laid out on the merged dim over it
    (a local slice): a product against rows split over that dim would
    split it so all the same, and the backward's gradient would then come
    split inside a head, which no view back to heads takes; this way the
    gradient is gathered (the redistribution's backward) before that
    view."""
    n = x.shape[-2]
    y = x.reshape(*x.shape[:-2], n * x.shape[-1])
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Shard

    mesh = y.device_mesh
    pl = tuple(Shard(y.dim() - 1) if p.is_replicate() and n % mesh.size(i) else p
               for i, p in enumerate(y.placements))
    return y if pl == tuple(y.placements) else y.redistribute(mesh, pl)


def on_rows(fn, acts: tuple, params: dict | None = None):
    """``fn(params, *acts)`` for a computation independent from batch row to
    batch row (a recurrence, an embedding lookup, the loss's rows). With
    DTensor operands it runs on plain tensors, each rank on its own batch
    rows: every act laid out with dim 0 over the mesh dims that shard any
    act's batch and the rest gathered, each parameter gathered (its
    gradient a partial sum over those mesh dims); so a recurrence's Python
    loop pays no DTensor dispatch a step, and no op in ``fn`` needs a
    DTensor rule. Its outputs (a tensor, a tuple, or a dict of (B, ...)
    tensors) come back as DTensors on those rows. Plain operands go
    straight to ``fn``."""
    ref = next((a for a in acts if is_dtensor(a)), None)
    if ref is None:
        return fn(params, *acts)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = ref.device_mesh
    by_rows = [any(is_dtensor(a) and a.placements[i].is_shard()
                   and a.placements[i].dim % a.dim() == 0 for a in acts)
               for i in range(mesh.ndim)]
    rows = tuple(Shard(0) if r else Replicate() for r in by_rows)
    partial = tuple(Partial() if r else Replicate() for r in by_rows)
    whole = (Replicate(),) * mesh.ndim
    local_acts = [replicated_like(a, ref).redistribute(mesh, rows).to_local() for a in acts]
    local_params = params and {
        k: v.redistribute(mesh, whole).to_local(grad_placements=partial) if is_dtensor(v) else v
        for k, v in params.items()}
    out = fn(local_params, *local_acts)

    def back(t):
        return DTensor.from_local(t, mesh, rows, run_check=False)

    if isinstance(out, dict):
        return {k: back(t) for k, t in out.items()}
    if isinstance(out, tuple):
        return tuple(back(t) if isinstance(t, torch.Tensor) else
                     {k: back(u) for k, u in t.items()} for t in out)
    return back(out)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    # Rounded to x's dtype before the gain, where the reference rounds.
    return (xf * scale).to(x.dtype) * gamma


# ---------------------------------------------------------------------------
# Rotary embeddings.
# ---------------------------------------------------------------------------


def mrope_sections(cfg: ArchConfig) -> tuple[int, int, int]:
    """How many of the head_dim/2 frequency pairs the (t, h, w) position ids
    drive, in that order: the config's sections rescaled to head_dim/2 as
    the reference rescales them (t and h rounded down, w the rest)."""
    half = cfg.head_dim // 2
    s0, s1, s2 = cfg.mrope_sections
    tot = s0 + s1 + s2
    n0, n1 = (s0 * half) // tot, (s1 * half) // tot
    return n0, n1, half - n0 - n1


def rope_angles(cfg: ArchConfig, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape (B, T, head_dim/2), f32.

    ``positions``: (B, T) integers for plain RoPE, or (B, T, 3) for M-RoPE,
    the trailing axis the (temporal, height, width) ids. M-RoPE gives each
    frequency pair one of the three components (Qwen2-VL §3.1): the first
    pairs take t, the next h, the last w (:func:`mrope_sections`), each
    angle that component's id times the pair's frequency. With the three ids
    equal (text) it is plain RoPE."""
    half = cfg.head_dim // 2
    # The exponents in f32 as the reference's; the power in f64, rounded
    # once to f32: the correctly rounded table XLA's f32 power gives, where
    # torch's f32 power is an ulp off on some frequencies.
    exponent = -torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = replicated_like((cfg.rope_theta ** exponent.double()).float(), positions)
    if positions.dim() == 2:
        pos = positions.float()[..., None]  # (B, T, 1)
    elif positions.dim() == 3 and positions.shape[-1] == 3:
        # The reference's take_along_axis of a section id per pair, built on
        # the device without a copy from the host or a wait for it.
        n0, n1, _ = mrope_sections(cfg)
        pair = torch.arange(half, device=positions.device)
        sec_id = replicated_like((pair >= n0).long() + (pair >= n0 + n1).long(), positions)
        pos = positions.float()[..., sec_id]  # (B, T, half)
    else:
        raise ValueError(f"positions must be (B, T) or (B, T, 3), got {tuple(positions.shape)}")
    angles = pos * freqs  # (B, T, half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, T, n_heads, head_dim); llama-style half rotation."""
    half = x.shape[-1] // 2
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention.
# ---------------------------------------------------------------------------


def init_attention(generator: torch.Generator | None, cfg: ArchConfig) -> dict:
    dt = dtype_of(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": init_dense(generator, d, cfg.n_heads * hd, dt),
        "wk": init_dense(generator, d, cfg.n_kv_heads * hd, dt),
        "wv": init_dense(generator, d, cfg.n_kv_heads * hd, dt),
        "wo": init_dense(generator, cfg.n_heads * hd, d, dt,
                         scale=0.02 / (2 * cfg.n_layers) ** 0.5),
    }
    if cfg.qkv_bias:
        device = p["wq"].device
        p["bq"] = torch.zeros((cfg.n_heads * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=device)
    return p


def project_qkv(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """x (B, T, d) -> q (B, T, H, hd), k/v (B, T, KV, hd), RoPE applied."""
    hd = cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, cfg.n_heads, hd)
    k = split_heads(k, cfg.n_kv_heads, hd)
    v = split_heads(v, cfg.n_kv_heads, hd)
    if cfg.rope != "none":
        cos, sin = rope_angles(cfg, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def apply_attention(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """Full-sequence path (prefill, forward): returns (out, (k, v)), k and v
    (B, T, KV, hd) for the cache.

    The reference's ``sdpa`` becomes one ``ops.attention`` call on
    (B, H, T, hd) views of the projections: the kernel reads them through
    their strides and writes its output laid out as (B, T, H, hd), so the
    merge of its heads below costs no copy.
    """
    check_supported(cfg)
    q, k, v = project_qkv(p, cfg, x, positions)
    out = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=cfg.causal, window=cfg.window)
    return merge_heads(out.transpose(1, 2)) @ p["wo"], (k, v)


# ---------------------------------------------------------------------------
# SwiGLU MLP.
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator | None, cfg: ArchConfig) -> dict:
    dt = dtype_of(cfg)
    return {
        "w_gate": init_dense(generator, cfg.d_model, cfg.d_ff, dt),
        "w_up": init_dense(generator, cfg.d_model, cfg.d_ff, dt),
        "w_down": init_dense(generator, cfg.d_ff, cfg.d_model, dt,
                             scale=0.02 / (2 * cfg.n_layers) ** 0.5),
    }


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
