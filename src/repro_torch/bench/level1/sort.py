"""Level 1: Sort — key-value sort (radix sort in the paper).

Counterpart of ``repro/bench/level1/sort.py``: int32 keys in [0, 2^30)
carrying int32 values, sorted by the hand-written radix-sort kernel
(``--impl kernel``, ``kernels/bitonic_sort.py``) or the plain PyTorch
oracle, a stable ``torch.sort`` (``--impl torch``). The FLOP count is the
reference's, the compare-exchanges of its bitonic network, kept as it is so
that both packages' rows report the same work.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register
from repro_torch.kernels import ops


def _pairs(keys: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Each (key, value) pair as one int64, so that sorting compares pairs."""
    return (keys.long() << 32) | (values.long() & 0xFFFFFFFF)


def _make(n: int) -> Workload:
    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        keys = rng.integers(0, 1 << 30, size=n, dtype=np.int32)
        vals = rng.integers(0, 1 << 30, size=n, dtype=np.int32)
        return (torch.from_numpy(keys), torch.from_numpy(vals))

    def fn(keys, vals):
        return ops.sort_kv(keys, vals)

    def validate(out, args):
        # On the device: keys ascending, and the same multiset of (key,
        # value) pairs as the input (the reference compares the key and the
        # value multisets one by one; pairs are the stronger check).
        keys, vals = args
        ko, vo = out
        assert bool((ko[1:] >= ko[:-1]).all()), "keys not sorted"
        got = torch.sort(_pairs(ko, vo)).values
        want = torch.sort(_pairs(keys, vals)).values
        assert torch.equal(got, want), "the (key, value) pairs changed"

    log2n = max(1, int(np.ceil(np.log2(n))))
    return Workload(
        name=f"sort.n{n}",
        fn=fn,
        make_inputs=make_inputs,
        flops=float(n * log2n * (log2n + 1) / 2),  # the reference's compare-exchanges
        bytes_moved=16.0 * n,
        validate=validate,
        # Opt out, as the reference: every pass scatters across the whole
        # array, so there is no independent batch dim.
        batch_dims=None,
        kernel="sort_kv",
    )


register(
    BenchmarkSpec(
        name="sort",
        level=1,
        dwarf="Sorting",
        domain=None,
        cuda_feature=None,
        gpu_feature="LSD radix sort, 8-bit digits, stable in-tile ranks (CUDA)",
        presets=geometric_presets({"n": 1 << 12}, scale_keys={"n": 8.0}, round_to=128),
        build=lambda n: _make(n),
    )
)
