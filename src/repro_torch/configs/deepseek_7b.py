"""deepseek-7b — llama-arch dense transformer [arXiv:2401.02954].

30L, d_model 4096, 32 heads (kv=32 → MHA), d_ff 11008, vocab 102400.
The port's copy of ``repro/configs/deepseek_7b.py``.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-7b",
        family="dense",
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab=102400,
        notes="llama-arch, full MHA KV",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-7b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=128,
    )
