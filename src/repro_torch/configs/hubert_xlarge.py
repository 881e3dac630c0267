"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447].

48L, d_model 1280, 16 heads (kv=16), head_dim 80, d_ff 5120, vocab 504
(cluster units). The conv waveform frontend is a stub: the model takes
precomputed frame embeddings (B, T, 1280); training is masked-unit
prediction over the 504 units. Encoder-only and bidirectional: no decode.
The port's copy of ``repro/configs/hubert_xlarge.py``.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab=504,
        causal=False,
        encoder_only=True,
        input_mode="embeds",
        rope="none",
        notes="encoder-only; frame-embedding frontend stub",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=32,
        causal=False,
        encoder_only=True,
        input_mode="embeds",
        rope="none",
    )
