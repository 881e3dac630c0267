"""qwen1.5-0.5b — dense transformer with QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L, d_model 1024, 16 heads (kv=16 → MHA), d_ff 2816, vocab 151936, tied
embeddings.
The port's copy of ``repro/configs/qwen1_5_0_5b.py``.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=2816,
        vocab=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1e6,
        notes="QKV bias; tied embeddings",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-0.5b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=128,
        qkv_bias=True,
        tie_embeddings=True,
    )
