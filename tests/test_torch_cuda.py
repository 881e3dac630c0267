"""The port's CUDA kernels against their plain versions, on a card.

These tests need a CUDA card and nvcc, and skip without them. On a machine
with a card (``--noconftest``: the shared conftest imports JAX, which such a
machine need not have):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.engine import Engine
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels import matmul, softmax

pytestmark = pytest.mark.cuda

MATMUL_SHAPES = [(8, 8, 8), (128, 128, 128), (130, 70, 50), (1, 256, 33), (257, 1, 128)]
SOFTMAX_SHAPES = [(1, 8), (33, 257), (64, 64), (7, 1031), (3, 40000)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tol(dtype) -> float:
    return 1e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nn", "tn"])
def test_matmul_kernel_matches_plain(card, m, k, n, dtype, layout):
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((m, k), dtype=np.float32)
    if layout == "tn":  # a transposed view, as the gemm "tn" specs pass
        a = torch.from_numpy(a_np.T.copy()).to(card, dtype).T
    else:
        a = torch.from_numpy(a_np).to(card, dtype)
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(card, dtype)
    got = matmul.matmul_cuda(a, b)
    torch.cuda.synchronize()
    want = matmul.matmul_plain(a, b)
    assert got.dtype == dtype and got.shape == (m, n)
    tol = _tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("rows,cols", SOFTMAX_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_kernel_matches_plain(card, rows, cols, dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(5 * rng.standard_normal((rows, cols), dtype=np.float32))
    x = x.to(card, dtype)
    got = softmax.softmax_cuda(x)
    torch.cuda.synchronize()
    # Relative only: most outputs of a 5*randn row lie far below any
    # absolute tolerance of the reference's size.
    torch.testing.assert_close(
        got.float(), softmax.softmax_plain(x).float(), rtol=_tol(dtype), atol=1e-30
    )


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    a = torch.ones(8, 8, device=card)
    with pytest.raises(ValueError, match="row- or column-major"):
        matmul.matmul_cuda(a[:, ::2].T, a)
    with pytest.raises(ValueError, match="float32 or two bfloat16"):
        matmul.matmul_cuda(a.half(), a.half())
    with pytest.raises(ValueError, match="unit stride"):
        softmax.softmax_cuda(a[:, ::2])


def test_kernel_rows_on_the_card_launch_the_kernels(card):
    before = sum(matmul.launches.values()), sum(softmax.launches.values())
    res = Engine().run(ExecutionPlan(
        names=("gemm_bf16_tn", "softmax"), preset=0, iters=2, warmup=1,
        include_backward=False, impl="kernel",
    ))
    assert [r.status for r in res.records] == ["ok", "ok"]
    assert all(r.impl_interpret is False for r in res.records)
    calls = 1 + 1 + 1 + 2 * (1 + 4)
    after = sum(matmul.launches.values()), sum(softmax.launches.values())
    assert (after[0] - before[0], after[1] - before[1]) == (calls, calls)
