"""Input shapes of every (architecture × input shape) cell, as meta tensors.

Counterpart of ``repro/launch/specs.py``: the four assigned shapes with the
reference's sizes, its applicability rule and reasons, and its batch specs.
Where the reference returns ``jax.ShapeDtypeStruct`` stand-ins, the port
returns tensors on the ``meta`` device: the same shapes and dtypes, no
storage, and a trace of the model can run on them.

- ``train_4k``:    seq 4096 × global batch 256  → the train step
- ``prefill_32k``: seq 32768 × global batch 32  → ``prefill`` (an encoder:
  ``forward``)
- ``decode_32k``:  KV len 32768 × batch 128     → ``decode_step``
- ``long_500k``:   KV len 524288 × batch 1      → ``decode_step``

Applicability: encoder-only archs have no decode; pure full-attention archs
skip ``long_500k`` (it needs sub-quadratic attention); sliding-window,
recurrent and hybrid archs run it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig

__all__ = ["SHAPES", "ShapeSpec", "applicability", "input_specs", "token_dtype"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq: int
    batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sub_quadratic(cfg: ArchConfig) -> bool:
    """Can this arch decode a 524k context without O(S) full-attention reads
    growing quadratically in total? Recurrent state is O(1); a window is
    O(window)."""
    kinds = cfg.block_kinds()
    has_full_attn = any(k.startswith("attn") for k in kinds) and cfg.window is None
    return not has_full_attn or cfg.family in ("ssm",)


def applicability(cfg: ArchConfig, shape: str | ShapeSpec) -> tuple[bool, str]:
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    if spec.kind == "decode" and cfg.encoder_only:
        return False, "encoder-only: no autoregressive decode step"
    if spec.name == "long_500k":
        if cfg.family == "hybrid":
            # Jamba: full attention layers, but 1:7 diluted with O(1) Mamba;
            # runs per the assignment (SSM/hybrid listed as eligible).
            return True, ""
        if not _sub_quadratic(cfg):
            return False, "pure full-attention arch: 524k decode needs sub-quadratic attention"
    return True, ""


def token_dtype() -> torch.dtype:
    return torch.int32


def input_specs(cfg: ArchConfig, shape: str | ShapeSpec) -> dict:
    """Meta tensors for the *batch* of this cell (parameter and cache
    shapes come from a ``Model`` on the meta device): tokens int32, or
    embeddings in the model's dtype with M-RoPE's (B, T, 3) int32 positions;
    int32 labels for training; a decode step's tokens (B,) and its 0-d
    int32 ``pos``."""
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    b, t = spec.batch, spec.seq
    i32 = token_dtype()

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if spec.kind in ("train", "prefill"):
        if cfg.input_mode == "embeds":
            batch = {"embeds": meta((b, t, cfg.d_model), _DTYPES[cfg.dtype])}
            if cfg.rope == "mrope":
                batch["positions"] = meta((b, t, 3), i32)
        else:
            batch = {"tokens": meta((b, t), i32)}
        if spec.kind == "train":
            batch["labels"] = meta((b, t), i32)
        return batch
    # decode: one new token against a cache of length seq
    return {"tokens": meta((b,), i32), "pos": meta((), i32)}
