"""Deterministic synthetic data: stateless, step-indexed, resumable.

Counterpart of ``repro/data/synthetic.py``. A batch is a pure function of
(seed, step), so checkpoint and restore need only the integer cursor. The
stream is the reference's: on an alphabet of ``v_eff = min(V, 257)``
symbols, ``x_{t+1} = (31·x_t + 7 + n_t) mod v_eff`` with n_t ~ Bernoulli(0.1),
so the next token is learnable and training loss falls. The draws come from
numpy (``np.random.default_rng([seed, step])``), not ``jax.random``, so the
port's batches are not the reference's: parity tests hand the reference's
batches to both packages.
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
    """Not ported: the frontend-stub batches of the audio and VLM archs."""

    d_model: int
    vocab: int
    batch: int
    seq: int
    mrope: bool = False
    seed: int = 0

    def __post_init__(self) -> None:
        raise NotImplementedError(
            "SyntheticEmbeds feeds the encoder-only and VLM archs (input_mode='embeds'), "
            "which are ROADMAP.md queue 1, item 16.4"
        )
