"""mixtral-8x22b — sparse MoE with sliding-window attention [arXiv:2401.04088].

56L, d_model 6144, 48 heads (GQA kv=8), d_ff 16384, vocab 32768, 8 experts
top-2, SWA window 4096: decode keeps a ring of 4096 cache slots, whatever
the sequence's length. The port's copy of ``repro/configs/mixtral_8x22b.py``.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=32768,
        n_experts=8,
        top_k=2,
        window=4096,
        rope_theta=1e6,
        notes="8 experts top-2; SWA ring cache",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=128,
        n_experts=4,
        top_k=2,
        window=16,
        moe_group_size=64,
        capacity_factor=2.0,
    )
