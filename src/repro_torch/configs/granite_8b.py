"""granite-8b — llama-arch code model [arXiv:2405.04324].

36L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 49152.
The port's copy of ``repro/configs/granite_8b.py``.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=49152,
        notes="llama-arch, code",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="granite-8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=128,
    )
