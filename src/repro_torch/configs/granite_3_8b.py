"""granite-3-8b — dense GQA transformer [hf:ibm-granite/granite-3.0-2b-base].

40L, d_model 4096, 32 heads (GQA kv=8), d_ff 12800, vocab 49155 (not a
multiple of any power of two above 1: the uneven-vocab case). The port's
copy of ``repro/configs/granite_3_8b.py``.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab=49155,
        notes="GQA; uneven vocab sharding",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=131,  # keep the uneven-vocab property
    )
