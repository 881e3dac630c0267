"""xlstm-350m — alternating sLSTM + mLSTM blocks [arXiv:2405.04517].

24L, d_model 1024, 4 heads, d_ff 0 (block-internal projections), vocab
50304. Attention-free: its decode state is O(1) in the context's length.
The port's copy of ``repro/configs/xlstm_350m.py``.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab=50304,
        xlstm_heads=4,
        rope="none",
        notes="sLSTM + mLSTM; attention-free; O(1) decode state",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-350m-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=0,
        vocab=128,
        xlstm_heads=4,
        rope="none",
    )
