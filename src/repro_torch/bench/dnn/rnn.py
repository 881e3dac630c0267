"""DNN: RNN — LSTM layer forward and backward over a sequence (paper: LSTM
via cuDNN).

Counterpart of ``repro/bench/dnn/rnn.py``: one fused-gate LSTM (the 4-gate
projection is one product per operand, the ``maxwell_sgemm_128x64_tn`` of
Table II). The reference's ``lax.scan`` over time becomes a Python loop with
the same cell. The products stay ``@`` (cuBLAS, TF32 off), as the reference
computes them outside its kernel layer; there is no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.dnn.common import dnn_workload
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import DNN_DOMAIN, BenchmarkSpec, register


def lstm_forward(x, wx, wh, b):
    """x (B, T, D); wx (D, 4H); wh (H, 4H); b (4H,) -> outputs (B, T, H)."""
    batch, seq = x.shape[:2]
    hidden = wh.shape[0]
    h = x.new_zeros((batch, hidden))
    c = x.new_zeros((batch, hidden))
    hs = []
    for t in range(seq):
        gates = x[:, t] @ wx + h @ wh + b[None]
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _make(batch: int, seq: int, d: int, h: int):
    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        return (
            torch.from_numpy(rng.standard_normal((batch, seq, d), dtype=np.float32)),
            torch.from_numpy(
                np.float32(d**-0.5) * rng.standard_normal((d, 4 * h), dtype=np.float32)
            ),
            torch.from_numpy(
                np.float32(h**-0.5) * rng.standard_normal((h, 4 * h), dtype=np.float32)
            ),
            torch.zeros(4 * h, dtype=torch.float32),
        )

    def validate(out, args):
        assert tuple(out.shape) == (batch, seq, h), tuple(out.shape)
        assert bool(torch.isfinite(out).all()), "non-finite LSTM output"
        assert bool((out.abs() <= 1.0).all()), "h = o * tanh(c) must lie in [-1, 1]"

    flops = 2.0 * batch * seq * (d + h) * 4 * h
    return dnn_workload(
        f"rnn.lstm.b{batch}.t{seq}.d{d}.h{h}",
        lstm_forward,
        make_inputs,
        flops=flops,
        bytes_moved=4.0 * (batch * seq * (d + h) + (d + h) * 4 * h),
        validate=validate,
        diff_argnums=(0, 1, 2, 3),
        batch_dims=(0, None, None, None),
    )


register(
    BenchmarkSpec(
        name="rnn",
        level=2,
        dwarf="Dense linear algebra",
        domain=DNN_DOMAIN,
        cuda_feature=None,
        gpu_feature="fused-gate LSTM, Python loop over time (cuBLAS f32)",
        presets=geometric_presets(
            {"batch": 16, "seq": 32, "d": 128, "h": 128},
            scale_keys={"batch": 2.0, "d": 2.0, "h": 2.0},
            round_to=32,
        ),
        build=lambda batch, seq, d, h: _make(batch, seq, d, h),
    )
)
