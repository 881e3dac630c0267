"""Cross-process persistence of the tune stage's winners.

Counterpart of ``repro/core/hlocache.py``, of its tune sidecar alone. The
reference persists two tiers of compile artifacts (a serialized executable
and the lowered HLO text) and, beside them, ``<key>.tune.json``: the block
configuration its ``_stage_tune`` selected. Only that third file is ported.
PyTorch has no serialized executable: the port's compile stage binds a
Python callable, and the kernels' shared library already persists under
``build/repro_torch/``, named by a hash of its sources
(``kernels/_build.py``).

A winner is keyed on the *base* compile-cache key, the one without tuned
parameters, so a warm ``--tune`` run finds it before it knows the answer
and performs zero trials. Entries live in a directory versioned by a
content hash of the ``repro_torch`` package (its ``*.py`` files and
``kernels/csrc/*.cu``/``*.cuh``: an edited kernel misses), by
``torch.__version__`` and ``torch.version.cuda``, and by the device:
``torch.cuda.get_device_name(0)``, or ``cpu`` on a host without one. A
winner timed on the CPU, or on another card, is never restored on this one.

A sidecar that exists but cannot be used (unparseable, a stale format,
parameters that are not positive ints, a winner outside the kernel's
current ``tune_space()``) is counted in ``tune_fallbacks`` with its reason
in ``last_tune_fallback``, and the engine sweeps again and overwrites it:
the cache can make a run skip its sweep, never pick a tile that was not
timed. A missing file is a cold miss and is not counted.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from pathlib import Path
from typing import Sequence

import torch

__all__ = ["HloDiskCache"]

_FORMAT_VERSION = 1
_PKG_ROOT = Path(__file__).resolve().parents[1]  # src/repro_torch


def _source_digest() -> str:
    """Content hash of the package's Python files and kernel sources: the
    cache key says *which* workload, this says *which code*."""
    h = hashlib.sha256()
    paths = sorted(
        p for p in _PKG_ROOT.rglob("*")
        if p.suffix == ".py" or (p.parent.name == "csrc" and p.suffix in (".cu", ".cuh"))
    )
    for path in paths:
        h.update(str(path.relative_to(_PKG_ROOT)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def _device_token() -> str:
    name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", name) or "unknown"


class HloDiskCache:
    """The tune stage's winners on disk, one ``<hash of key>.tune.json``
    each, with hit, store and fallback counters."""

    def __init__(self, root: str) -> None:
        self.root = os.path.join(
            root,
            f"torch-{torch.__version__}-cuda-{torch.version.cuda or 'none'}-"
            f"{_device_token()}-{_source_digest()}",
        )
        os.makedirs(self.root, exist_ok=True)
        self.tune_hits = 0  # winners restored (the pass ran zero trials)
        self.tune_stores = 0  # winners persisted
        self.tune_fallbacks = 0  # sidecars present but unusable: swept again
        self.last_tune_fallback: str | None = None

    def _tune_path(self, key: tuple) -> str:
        digest = hashlib.sha256(repr(key).encode()).hexdigest()[:24]
        return os.path.join(self.root, f"{digest}.tune.json")

    def counter_dict(self) -> dict[str, int]:
        """The counters as a plain dict: what the engine stamps into
        ``RunMetadata.cache_stats``, so a report says whether its run was
        warm."""
        return {
            "tune_hits": self.tune_hits,
            "tune_stores": self.tune_stores,
            "tune_fallbacks": self.tune_fallbacks,
        }

    def summary(self) -> str:
        """One-line diagnosis for the CLI."""
        line = (
            f"hlocache: tune_hits={self.tune_hits} tune_stores={self.tune_stores} "
            f"tune_fallbacks={self.tune_fallbacks}"
        )
        if self.last_tune_fallback is not None:
            line += f" last_tune_fallback=[{self.last_tune_fallback}]"
        return line

    def store_tuned(self, key: tuple, params: dict, trials: int, trials_us: float) -> None:
        """Persist the winner for ``key`` (the base compile-cache key) and
        what its sweep cost, atomically."""
        payload = {
            "format": _FORMAT_VERSION,
            "params": dict(params),
            "trials": int(trials),
            "trials_us": float(trials_us),
        }
        path = self._tune_path(key)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        self.tune_stores += 1

    def load_tuned(self, key: tuple, candidates: Sequence[dict] | None = None) -> dict | None:
        """The persisted winner for ``key``, or None: cold, or a sidecar
        that cannot be used (counted). With ``candidates``, a winner that is
        not one of them is unusable too."""
        path = self._tune_path(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                payload = json.load(f)
            if payload.get("format") != _FORMAT_VERSION:
                raise ValueError(f"stale tune cache format {payload.get('format')!r}")
            params = payload["params"]
            if not isinstance(params, dict) or not all(
                isinstance(k, str) and type(v) is int and v > 0 for k, v in params.items()
            ):
                raise ValueError(f"params {params!r} are not positive ints by name")
            if candidates is not None and params not in [dict(c) for c in candidates]:
                raise ValueError(f"winner {params} is not a candidate of {list(candidates)}")
        except (OSError, ValueError, KeyError, TypeError, AttributeError) as e:
            self.tune_fallbacks += 1
            name = key[0] if key else "?"
            self.last_tune_fallback = " ".join(f"{name}: {type(e).__name__}: {e}".split())[:200]
            return None
        self.tune_hits += 1
        return params
