"""DNN: Convolution — 2-D convolution forward and backward.

Counterpart of ``repro/bench/dnn/convolution.py``. Two paths, both
benchmarked under the reference's names, so records line up with its rows:

- ``xla`` (``convolution_xla``): ``F.conv2d``, that is cuDNN, in true f32
  (the engine turns cuDNN's TF32 off at the start of a run). It stands where
  the reference has XLA's native convolution; it has no kernel of its own.
- ``im2col`` (``convolution_im2col``): the patches built exactly as the
  reference builds them, then one batched call of the hand-written GEMM
  (``ops.matmul``, ``kernel="matmul"``): the shared weight matrix times
  every image's patch matrix, where the reference vmaps the GEMM over the
  images. Validated against ``F.conv2d``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.bench.dnn.common import dnn_workload
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import DNN_DOMAIN, BenchmarkSpec, register
from repro_torch.kernels import ops


def conv2d_xla(x, w):
    """x (N, C, H, W), w (O, C, KH, KW), VALID padding, stride 1."""
    return F.conv2d(x, w)


def conv2d_im2col(x, w):
    n, c, h, wd = x.shape
    o, _, kh, kw = w.shape
    oh, ow = h - kh + 1, wd - kw + 1
    cols = torch.stack(
        [x[:, :, i : i + oh, j : j + ow] for i in range(kh) for j in range(kw)],
        dim=2,
    )  # (N, C, KH*KW, OH, OW)
    cols = cols.reshape(n, c * kh * kw, oh * ow)
    wmat = w.reshape(o, c * kh * kw)
    out = ops.matmul(wmat, cols)  # (N, O, OH*OW): one batched GEMM
    return out.reshape(n, o, oh, ow)


def _make(n: int, c: int, hw: int, o: int, k: int, impl: str):
    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        s = np.float32((c * k * k) ** -0.5)
        return (
            torch.from_numpy(rng.standard_normal((n, c, hw, hw), dtype=np.float32)),
            torch.from_numpy(s * rng.standard_normal((o, c, k, k), dtype=np.float32)),
        )

    fn = conv2d_im2col if impl == "im2col" else conv2d_xla

    def validate(out, args):
        # On the tensors' device: at preset 4 the output is 59 MB.
        torch.testing.assert_close(out, conv2d_xla(*args), rtol=2e-4, atol=2e-4)

    oh = hw - k + 1
    flops = 2.0 * n * o * c * k * k * oh * oh
    return dnn_workload(
        f"convolution.{impl}.{n}x{c}x{hw}.o{o}k{k}",
        fn,
        make_inputs,
        flops=flops,
        bytes_moved=4.0 * (n * c * hw * hw + o * c * k * k + n * o * oh * oh),
        validate=validate,
        diff_argnums=(0, 1),
        batch_dims=(0, None),
        # Only the im2col variant reaches the kernel layer; the xla variant
        # is cuDNN by definition (this spec's own `impl` preset key is the
        # conv algorithm, orthogonal to the plan's impl axis).
        kernel="matmul" if impl == "im2col" else None,
    )


for _impl in ("xla", "im2col"):
    register(
        BenchmarkSpec(
            name=f"convolution_{_impl}",
            level=2,
            dwarf="Dense linear algebra",
            domain=DNN_DOMAIN,
            cuda_feature=None,
            gpu_feature=(
                "im2col + batched TMA f32 FMA GEMM (CUDA)" if _impl == "im2col"
                else "cuDNN convolution, TF32 off"
            ),
            presets=geometric_presets(
                {"n": 4, "c": 16, "hw": 32, "o": 16, "k": 3, "impl": _impl},
                scale_keys={"n": 2.0, "c": 2.0, "o": 2.0},
                round_to=4,
            ),
            build=lambda n, c, hw, o, k, impl: _make(n, c, hw, o, k, impl),
        )
    )
