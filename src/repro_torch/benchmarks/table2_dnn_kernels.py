"""Table II: per-DNN-layer kernel classification.

Counterpart of ``benchmarks/table2_dnn_kernels.py``. The paper maps each
layer to its cuDNN kernel and classifies convolution as compute-bound and
batch norm as memory-bound from IPC and eligible-warp metrics (§V-A). Here
each layer maps to what runs it on the card, and the classification falls
out of the roofline terms: convolution lands compute-dominant and
batchnorm memory-dominant.

The kernel column is the engine's ``impl`` axis: a layer with a
hand-written kernel gets one row per implementation, the torch path and
the kernel (``.kernel``, the reference's ``.pallas``), both characterized
through :meth:`Engine.characterize`, which compiles through the engine's
cache and does not time. Kernel backward rows are left out: a kernel plan
runs backward passes on torch, so such a row would repeat its torch twin.

``flops`` and ``bytes`` are the workload's analytic counts (its ``flops``,
``flops_bwd`` and ``bytes_moved``), held against the card's peaks for the
row's dtype; the reference prints XLA's cost analysis of the compiled
program instead, which PyTorch has no counterpart of.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import Row
from repro_torch.core.engine import Engine
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.registry import get_benchmark

# name -> (torch label, kernel label or None, classification).
_KERNEL_MAP = {
    "activation": ("torch:relu", None, "elementwise"),
    "pooling": ("torch:reshape-mean", "kernel:avgpool_f32", "reduce"),
    "batchnorm": ("torch:mean/var/rsqrt chain", None, "stats+scale"),
    "connected": ("torch:matmul (cuBLAS)", "kernel:matmul_f32 (TMA+FMA)", "gemm"),
    "convolution_xla": ("torch:cudnn conv", None, "conv"),
    "convolution_im2col": (
        "torch:matmul via im2col (cuBLAS)", "kernel:matmul_f32_batched via im2col", "gemm",
    ),
    "dropout": ("torch:philox rand+where", None, "prng+mask"),
    "rnn": ("torch:loop(gate gemm)", None, "scan-gemm"),
    "softmax": ("torch:softmax", "kernel:softmax_f32", "rowreduce"),
    "lrn": ("torch:window-sum chain", "kernel:lrn_f32", "window-reduce"),
}


def rows(preset: int = 1, *, device: str = "cuda") -> list[Row]:
    engine = Engine()
    out: list[Row] = []
    for name, (torch_kernel, kernel, kind) in _KERNEL_MAP.items():
        spec = get_benchmark(name)
        impls = ("torch",) if kernel is None else ("torch", "kernel")
        for impl in impls:
            plan = ExecutionPlan(preset=preset, impl=impl, device=device)
            w = spec.build_preset(plan.resolve_preset(spec))
            label = kernel if impl == "kernel" else torch_kernel
            for backward in (False, True):
                if backward and (w.fn_bwd is None or impl == "kernel"):
                    continue
                r = engine.characterize(spec, plan, backward=backward, workload=w).roofline
                suffix = ".kernel" if impl == "kernel" else ""
                out.append(
                    (
                        f"table2.{name}{suffix}{'.bwd' if backward else ''}",
                        0.0,
                        f"kernel={label};class={kind};impl={impl};"
                        f"dominant={r.dominant};"
                        f"ai={r.arithmetic_intensity():.2f};"
                        f"flops={r.flops:.3e};bytes={r.hbm_bytes:.3e}",
                    )
                )
    return out
