"""Architecture configs: one module per architecture the port runs.

Counterpart of ``repro/configs/__init__.py``: the port keeps its own copies
(it imports nothing of the JAX package). ``get_config(name)`` returns the
published configuration and ``get_smoke_config(name)`` a reduced
same-family variant for CPU tests.

``ARCHS`` lists the reference's ten architectures: the four dense ones
(attention + MLP), the two MoE ones (attention + MoE), the xLSTM one (mLSTM
and sLSTM blocks), the hybrid (Mamba and attention blocks, MLP and MoE
FFNs), the audio encoder (bidirectional, fed frame embeddings) and the VLM
(fed patch and text embeddings, M-RoPE). An unknown name raises
``KeyError``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

__all__ = ["ARCHS", "get_config", "get_smoke_config"]

ARCHS = ("granite-3-8b", "qwen1.5-0.5b", "granite-8b", "deepseek-7b", "xlstm-350m",
         "mixtral-8x22b", "dbrx-132b", "hubert-xlarge", "jamba-1.5-large-398b", "qwen2-vl-2b")

_MODULES = {
    name: "repro_torch.configs." + name.replace("-", "_").replace(".", "_") for name in ARCHS
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {', '.join(ARCHS)}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ArchConfig:
    cfg = _module(name).config()
    cfg.validate()
    return cfg


def get_smoke_config(name: str) -> ArchConfig:
    cfg = _module(name).smoke_config()
    cfg.validate()
    return cfg
