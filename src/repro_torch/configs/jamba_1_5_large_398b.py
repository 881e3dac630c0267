"""jamba-1.5-large-398b — Mamba+attention hybrid MoE [arXiv:2403.19887].

72L, d_model 8192, 64 heads (GQA kv=8), d_ff 24576, vocab 65536, MoE 16
experts top-2. Layout per the Jamba paper: period-8 blocks with ONE
attention layer per 7 Mamba layers (attention at in-period index 4), MoE on
every other layer. Attention carries no positional encoding (Jamba relies
on Mamba for position). The port's copy of
``repro/configs/jamba_1_5_large_398b.py``.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab=65536,
        n_experts=16,
        top_k=2,
        moe_every=2,
        moe_offset=1,
        attn_period=8,
        attn_offset=4,
        rope="none",
        ssm_state=16,
        ssm_expand=2,
        notes="1:7 attn:mamba, MoE every other layer",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b-smoke",
        family="hybrid",
        n_layers=8,  # one full period
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=128,
        n_experts=4,
        top_k=2,
        moe_every=2,
        moe_offset=1,
        attn_period=8,
        attn_offset=4,
        rope="none",
        ssm_state=4,
        ssm_expand=2,
        moe_group_size=64,
        capacity_factor=2.0,
    )
