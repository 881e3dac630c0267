"""Level 1: GUPS — giga-updates per second (random memory access).

Counterpart of ``repro/bench/level1/gups.py``: random read-modify-write
over a large table. The reference's ``table.at[idx].add(vals)`` becomes an
out-of-place ``index_add``, which on the card adds with float atomics, so
the order of updates to one row, and with it the last bits of that row,
varies from call to call.

``validate`` holds the result to an f64 evaluation of the same updates: each
row within the round-off of its own f32 additions, and the table's sum
within the sum of those bounds. The reference's check has no absolute value
(``gups.py:32-34``), so a negative difference always passed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register

U_F32 = 2.0**-24


def gups_update(table: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    return table.index_add(0, idx, vals)


def check_updates(out: torch.Tensor, table: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """``out`` against the updates summed in f64. A row that took m updates
    rounds m times, each time by at most u of its running sum, which is at
    most |table row| plus the sum of |updates| to it; twice that bound
    leaves room for the f64 sums' own error."""
    want = table.double().index_add(0, idx, vals.double())
    hits = torch.zeros_like(want).index_add_(0, idx, torch.ones_like(vals, dtype=torch.float64))
    mass = table.double().abs().index_add_(0, idx, vals.double().abs())
    bound = 2 * U_F32 * hits * mass
    err = (out.double() - want).abs()
    assert bool((err <= bound).all()), (
        f"a row is off by {float((err - bound).max()):.3e} beyond its round-off bound")
    total = float((out.double().sum() - table.double().sum() - vals.double().sum()).abs())
    assert total <= float(bound.sum()) + 1e-12 * float(mass.sum()), (
        f"the table's sum is off by {total:.3e}")


def _make(table_n: int, updates: int) -> Workload:
    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        return (
            torch.from_numpy(rng.standard_normal(table_n, dtype=np.float32)),
            torch.from_numpy(rng.integers(0, table_n, updates, dtype=np.int32)),
            torch.from_numpy(rng.standard_normal(updates, dtype=np.float32)),
        )

    def validate(out, args):
        check_updates(out, *args)

    return Workload(
        name=f"gups.t{table_n}.u{updates}",
        fn=gups_update,
        make_inputs=make_inputs,
        flops=float(updates),
        bytes_moved=12.0 * updates,  # idx read + table read + table write
        validate=validate,
        # Opt out, as the reference: any update may touch any row.
        batch_dims=None,
        meta={"updates": updates},
    )


register(
    BenchmarkSpec(
        name="gups",
        level=1,
        dwarf=None,
        domain=None,
        cuda_feature=None,
        gpu_feature="index_add with float atomics",
        presets=geometric_presets(
            {"table_n": 1 << 16, "updates": 1 << 14},
            scale_keys={"table_n": 8.0, "updates": 8.0},
            round_to=128,
        ),
        build=lambda table_n, updates: _make(table_n, updates),
    )
)
