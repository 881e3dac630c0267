"""Deterministic synthetic data: stateless, step-indexed, resumable.

Counterpart of ``repro/data/synthetic.py``. A batch is a pure function of
(seed, step), so checkpoint and restore need only the integer cursor. The
stream is the reference's: on an alphabet of ``v_eff = min(V, 257)``
symbols, ``x_{t+1} = (31·x_t + 7 + n_t) mod v_eff`` with n_t ~ Bernoulli(0.1),
so the next token is learnable and training loss falls. ``SyntheticEmbeds``
feeds the models whose frontend is a stub (``input_mode="embeds"``: the
audio encoder's frames, the VLM's patch and text embeddings) as the
reference's does: standard-normal f32 embeddings, uniform labels, and under
M-RoPE (B, T, 3) positions, ``arange(T)`` in each component. The draws come
from numpy (``np.random.default_rng([seed, step])``), not ``jax.random``, so
the port's batches are not the reference's: parity tests hand the
reference's batches to both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLM", "SyntheticEmbeds"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Next-token-prediction batches: {"tokens", "labels"}, (B, T) int32
    numpy arrays, the labels the tokens shifted by one."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng([self.seed, step])
        v_eff = min(self.vocab, 257)
        a = 31
        x = rng.integers(0, v_eff, size=self.batch, dtype=np.int64)
        noise = (rng.random((self.batch, self.seq + 1)) < 0.1).astype(np.int64)
        toks = np.empty((self.batch, self.seq + 1), dtype=np.int32)
        for t in range(self.seq + 1):
            x = (a * x + 7 + noise[:, t]) % v_eff
            toks[:, t] = x
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass(frozen=True)
class SyntheticEmbeds:
    """Frontend-stub batches: {"embeds" (B, T, d_model) f32, "labels" (B, T)
    int32 in [0, vocab)}, and "positions" (B, T, 3) int32 with ``mrope``;
    numpy arrays."""

    d_model: int
    vocab: int
    batch: int
    seq: int
    mrope: bool = False
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng([self.seed, step])
        embeds = rng.standard_normal((self.batch, self.seq, self.d_model), dtype=np.float32)
        labels = rng.integers(0, self.vocab, (self.batch, self.seq), dtype=np.int32)
        out = {"embeds": embeds, "labels": labels}
        if self.mrope:
            out["positions"] = np.broadcast_to(
                np.arange(self.seq, dtype=np.int32)[None, :, None],
                (self.batch, self.seq, 3)).copy()
        return out
