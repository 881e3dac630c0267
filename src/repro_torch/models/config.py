"""Architecture configuration for the model zoo.

Counterpart of ``repro/models/config.py``, kept as the port's own copy (the
port imports nothing of the JAX package): one ``ArchConfig`` describes any
of the reference's architectures and their reduced smoke variants, field for
field, so a config means the same in both packages. The port runs every
block kind, both input modes and M-RoPE (``models/model.py``,
``models/layers.py``); it refuses only the reference's XLA attention knobs
away from their defaults (``layers.check_supported``).

The layer stack is a repeating *period* of block kinds (``block_period``):
dense models have a period of one fused attention + MLP block; jamba has a
period of 8 mixed mamba/attention layers with MoE on alternating layers;
xLSTM alternates mLSTM/sLSTM blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
BlockKind = Literal[
    "attn_mlp",  # attention + dense SwiGLU MLP
    "attn_moe",  # attention + MoE FFN
    "mamba_mlp",  # Mamba mixer + dense MLP
    "mamba_moe",  # Mamba mixer + MoE FFN
    "mamba",  # Mamba mixer only (no FFN)
    "mlstm",  # xLSTM matrix-memory block (self-contained)
    "slstm",  # xLSTM scalar-memory block (self-contained)
]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # Attention flavour
    qkv_bias: bool = False
    window: int | None = None  # sliding-window attention width
    causal: bool = True  # False => bidirectional encoder
    rope: Literal["rope", "mrope", "none"] = "rope"
    rope_theta: float = 1e4
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # t/h/w pairs (half-dim)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # MoE FFN on layers where (layer % moe_every == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024
    # Expert slicing (§Perf mixtral iteration): split each expert's SwiGLU
    # into `moe_split` ff-slices = E·moe_split virtual experts. SwiGLU sums
    # over d_ff, so slices add exactly; 8 experts × split 2 = 16 virtual
    # experts divide a 16-way model axis → clean EP instead of ff-row-
    # parallel partial-sum all-reduces.
    moe_split: int = 1
    # SSM (Mamba)
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0  # 0 => ceil(d_model / 16)
    # Hybrid layout (jamba): one attention layer per `attn_period` layers
    attn_period: int = 0  # 0 => pure-attention stack
    attn_offset: int = 0
    # xLSTM
    xlstm_heads: int = 4
    # Chunkwise-parallel mLSTM (§Perf xlstm iteration): process the sequence
    # in chunks of this length — matrix-memory state traffic drops by the
    # chunk length; intra-chunk work becomes an attention-like (L×L) block.
    # 0 = sequential scan.
    xlstm_chunk: int = 0
    # Performance knobs of the reference's XLA attention; the port has no
    # counterpart and refuses values other than these defaults (layers.py).
    attn_chunk: int = 0  # >0: chunked online-softmax attention (KV blocks)
    score_dtype: str = "float32"  # attention score matmul accumulation dtype
    unroll_inner: bool = False  # unroll inner chunk scans (cost-analysis mode)
    # I/O
    input_mode: Literal["tokens", "embeds"] = "tokens"
    encoder_only: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # Numerics
    dtype: str = "bfloat16"
    # Notes carried into the docs' tables
    notes: str = ""

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    # ---- layer stack -----------------------------------------------------
    def block_kinds(self) -> tuple[BlockKind, ...]:
        """Kind of every layer, length n_layers."""
        kinds: list[BlockKind] = []
        for i in range(self.n_layers):
            moe = self.n_experts > 0 and (i % self.moe_every == self.moe_offset)
            if self.family == "ssm":
                kinds.append("mlstm" if i % 2 == 0 else "slstm")
            elif self.attn_period > 0:  # hybrid
                if i % self.attn_period == self.attn_offset:
                    kinds.append("attn_moe" if moe else "attn_mlp")
                else:
                    kinds.append("mamba_moe" if moe else "mamba_mlp")
            else:
                kinds.append("attn_moe" if moe else "attn_mlp")
        return tuple(kinds)

    def block_period(self) -> tuple[BlockKind, ...]:
        """Smallest repeating unit of the stack (the scan body)."""
        kinds = self.block_kinds()
        for p in range(1, len(kinds) + 1):
            if len(kinds) % p == 0 and kinds == kinds[:p] * (len(kinds) // p):
                return kinds[:p]
        return kinds

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.block_period())

    # ---- parameter counting (for MODEL_FLOPS = 6·N·D) ---------------------
    def param_counts(self) -> dict[str, float]:
        """Analytic parameter counts: total and active-per-token."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        mlp = 3 * d * ff
        moe_total = self.n_experts * mlp + d * self.n_experts
        moe_active = self.top_k * mlp + d * self.n_experts
        di, ds, dtr = self.d_inner, self.ssm_state, self.dt_rank
        mamba = (
            d * 2 * di  # in_proj
            + di * self.ssm_conv + di  # conv
            + di * (dtr + 2 * ds)  # x_proj
            + dtr * di + di  # dt_proj
            + di * ds + di  # A_log, D
            + di * d  # out_proj
        )
        dh = d // self.xlstm_heads
        mlstm = d * 2 * d + 2 * d * self.ssm_conv + 3 * (2 * d) * (2 * d) // 1 + 2 * d * d  # approx
        slstm = d * 4 * d + self.xlstm_heads * dh * dh * 4 + d * (4 * d // 3) * 2
        total = 0.0
        active = 0.0
        for kind in self.block_kinds():
            if kind.startswith("attn"):
                total += attn
                active += attn
            if kind.startswith("mamba"):
                total += mamba
                active += mamba
            if kind.endswith("_moe"):
                total += moe_total
                active += moe_active
            elif kind.endswith("_mlp"):
                total += mlp
                active += mlp
            if kind == "mlstm":
                total += mlstm
                active += mlstm
            if kind == "slstm":
                total += slstm
                active += slstm
            total += 2 * d  # norms
            active += 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total += emb + d
        active += emb + d
        return {"total": total, "active": active}

    def validate(self) -> None:
        assert self.n_heads * self.head_dim > 0
        assert self.n_heads % self.n_kv_heads == 0, (self.n_heads, self.n_kv_heads)
        if self.n_experts:
            assert 0 < self.top_k <= self.n_experts
        if self.family == "ssm":
            assert self.n_layers % 2 == 0, "xLSTM alternates mLSTM/sLSTM pairs"
        assert self.n_layers % len(self.block_period()) == 0
