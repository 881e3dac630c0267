"""dbrx-132b — fine-grained MoE [hf:databricks/dbrx-base].

40L, d_model 6144, 48 heads (GQA kv=8), d_ff 10752, vocab 100352, 16
experts top-4 (fine-grained: more, smaller experts than mixtral). The port's
copy of ``repro/configs/dbrx_132b.py``.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab=100352,
        n_experts=16,
        top_k=4,
        rope_theta=5e5,
        notes="16 experts top-4, fine-grained",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab=128,
        n_experts=8,
        top_k=4,
        moe_group_size=64,
        capacity_factor=2.0,
    )
