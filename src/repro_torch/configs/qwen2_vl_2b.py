"""qwen2-vl-2b — VLM backbone with M-RoPE [arXiv:2409.12191].

28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960, vocab 151936. The vision
frontend (dynamic-resolution ViT) is a stub: the model takes precomputed
patch and token embeddings plus 3-component (t, h, w) M-RoPE position ids.
QKV bias and tied embeddings per the published config. The port's copy of
``repro/configs/qwen2_vl_2b.py``.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope="mrope",
        rope_theta=1e6,
        mrope_sections=(16, 24, 24),
        input_mode="embeds",
        notes="M-RoPE; patch-embedding frontend stub",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=128,
        qkv_bias=True,
        tie_embeddings=True,
        rope="mrope",
        mrope_sections=(2, 3, 3),
        input_mode="embeds",
    )
