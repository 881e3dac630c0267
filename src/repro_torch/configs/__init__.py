"""Architecture configs: one module per architecture the port runs.

Counterpart of ``repro/configs/__init__.py``: the port keeps its own copies
(it imports nothing of the JAX package). ``get_config(name)`` returns the
published configuration and ``get_smoke_config(name)`` a reduced
same-family variant for CPU tests.

``ARCHS`` lists the architectures whose block kinds the port runs: the four
dense ones (attention + MLP), the two MoE ones (attention + MoE), the xLSTM
one (mLSTM and sLSTM blocks) and the hybrid (Mamba and attention blocks,
MLP and MoE FFNs). The reference's other two (the audio encoder, the VLM)
wait for their input mode and M-RoPE: asking for one raises a ``KeyError``
that says so.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

__all__ = ["ARCHS", "get_config", "get_smoke_config"]

ARCHS = ("granite-3-8b", "qwen1.5-0.5b", "granite-8b", "deepseek-7b", "xlstm-350m",
         "mixtral-8x22b", "dbrx-132b", "jamba-1.5-large-398b")
# The reference's architectures that the port does not run yet.
NOT_PORTED = ("hubert-xlarge", "qwen2-vl-2b")

_MODULES = {
    name: "repro_torch.configs." + name.replace("-", "_").replace(".", "_") for name in ARCHS
}


def _module(name: str):
    if name in NOT_PORTED:
        raise KeyError(
            f"arch {name!r} is not ported yet: its embeddings input or M-RoPE "
            "are ROADMAP.md queue 1, item 16.4; ported: " + ", ".join(ARCHS)
        )
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; ported: {', '.join(ARCHS)}; the reference's "
            f"others ({', '.join(NOT_PORTED)}) are ROADMAP.md queue 1, item 16.4"
        )
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ArchConfig:
    cfg = _module(name).config()
    cfg.validate()
    return cfg


def get_smoke_config(name: str) -> ArchConfig:
    cfg = _module(name).smoke_config()
    cfg.validate()
    return cfg
