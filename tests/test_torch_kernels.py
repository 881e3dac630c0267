"""The port's kernel layer against the JAX reference, on the CPU.

The same numpy-seeded inputs go through the reference (its Pallas kernels in
interpret mode, or its ``ref.py`` oracles) and through the port (the kernel
route, which runs the plain version for CPU tensors, or the port's oracles),
at the reference's own test shapes and tolerances. The CUDA kernels
themselves run only on a card: ``chip_smoke.py`` and ``test_torch_cuda.py``
hold them against these plain versions there.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.matmul import matmul_pallas
from repro.kernels.softmax import softmax_pallas
from repro_torch.convert import from_reference
from repro_torch.core import metrics
from repro_torch.kernels import _build, ops
from repro_torch.kernels import matmul as tmatmul
from repro_torch.kernels import ref as tref
from repro_torch.kernels import softmax as tsoftmax

# tests/test_kernels_matmul.py:11-17 and tests/test_kernels_misc.py:17-18
MATMUL_SHAPES = [(8, 8, 8), (128, 128, 128), (130, 70, 50), (1, 256, 33), (257, 1, 128)]
SOFTMAX_SHAPES = [(1, 8), (33, 257), (64, 64), (7, 1031)]
DTYPES = [np.float32, jnp.bfloat16]


def _tol(dtype) -> float:
    # The reference's tolerances: 1e-5 for f32, 2e-2 for bf16.
    return 1e-5 if dtype == np.float32 else 2e-2


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_kernel_route_matches_pallas(rng, m, k, n, dtype):
    a = jnp.asarray(rng.normal(size=(m, k)).astype(np.float32)).astype(dtype)
    b = jnp.asarray(rng.normal(size=(k, n)).astype(np.float32)).astype(dtype)
    want = matmul_pallas(a, b, block_m=64, block_n=64, block_k=32, interpret=True)
    ta, tb = from_reference([np.asarray(a), np.asarray(b)], "cpu")
    got = ops.matmul(ta, tb, mode="kernel")
    assert got.dtype == ta.dtype and tuple(got.shape) == (m, n)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("rows,cols", SOFTMAX_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_softmax_kernel_route_matches_pallas(rng, rows, cols, dtype):
    x = (5 * jnp.asarray(rng.normal(size=(rows, cols)).astype(np.float32))).astype(dtype)
    want = softmax_pallas(x, block_rows=16, block_cols=64, interpret=True)
    (tx,) = from_reference([np.asarray(x)], "cpu")
    got = ops.softmax(tx, mode="kernel")
    assert got.dtype == tx.dtype and got.shape == tx.shape
    # Relative only: most outputs of a 5*randn row lie far below any
    # absolute tolerance of the reference's size.
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=_tol(dtype), atol=1e-30)


def _oracle_cases(rng):
    f32 = np.float32
    x4 = rng.normal(size=(2, 13, 9, 11)).astype(f32)
    img = rng.uniform(0.2, 1.0, size=(32, 48)).astype(f32)
    q = rng.normal(size=(2, 4, 5, 8)).astype(f32)
    kv = rng.normal(size=(2, 2, 7, 8)).astype(f32)
    short_kv = rng.normal(size=(1, 2, 3, 8)).astype(f32)
    return {
        "matmul_f32": ("matmul_ref", (rng.normal(size=(130, 70)).astype(f32),
                                      rng.normal(size=(70, 50)).astype(f32)), {}, 1e-5),
        "matmul_bf16": ("matmul_ref", (jnp.asarray(rng.normal(size=(64, 48)), jnp.bfloat16),
                                       jnp.asarray(rng.normal(size=(48, 40)), jnp.bfloat16)),
                        {}, 2e-2),
        "attention": ("attention_ref", (q, kv, kv), {}, 2e-4),
        "attention_causal_window": ("attention_ref", (q, kv, kv),
                                    {"causal": True, "window": 3}, 2e-4),
        # T > S puts the first queries before every key: fully masked rows,
        # which both oracles define as zeros.
        "attention_fully_masked": ("attention_ref", (rng.normal(size=(1, 2, 5, 8)).astype(f32),
                                                     short_kv, short_kv),
                                   {"causal": True}, 2e-4),
        "softmax": ("softmax_ref", (5 * rng.normal(size=(33, 257)).astype(f32),), {}, 1e-5),
        "lrn5": ("lrn_ref", (x4,), {"size": 5}, 1e-5),
        "lrn3": ("lrn_ref", (x4,), {"size": 3, "alpha": 0.5, "beta": 0.5, "k": 1.0}, 1e-5),
        "avgpool2": ("avgpool_ref", (rng.normal(size=(2, 5, 8, 12)).astype(f32),),
                     {"ksize": 2}, 1e-6),
        "avgpool3": ("avgpool_ref", (rng.normal(size=(1, 8, 9, 9)).astype(f32),),
                     {"ksize": 3}, 1e-6),
        "srad": ("srad_step_ref", (img,), {}, 1e-5),
        "srad_params": ("srad_step_ref", (img,), {"lam": 0.25, "q0sqr": 0.1}, 1e-5),
        "prefix_scan": ("prefix_scan_ref", (rng.normal(size=(1000,)).astype(f32),), {}, 1e-4),
    }


@pytest.mark.parametrize("case", [
    "matmul_f32", "matmul_bf16", "attention", "attention_causal_window",
    "attention_fully_masked", "softmax", "lrn5", "lrn3", "avgpool2", "avgpool3",
    "srad", "srad_params", "prefix_scan",
])
def test_oracle_matches_reference(rng, case):
    name, args, kwargs, tol = _oracle_cases(rng)[case]
    want = getattr(jref, name)(*[jnp.asarray(a) for a in args], **kwargs)
    targs = from_reference([np.asarray(a) for a in args], "cpu")
    got = getattr(tref, name)(*targs, **kwargs)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert tuple(got.shape) == tuple(want.shape)
    assert np.isfinite(_np32(got)).all()
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("keys_kind", ["int32_with_ties", "float32"])
def test_sort_kv_oracle_matches_reference_exactly(rng, keys_kind):
    if keys_kind == "int32_with_ties":
        keys = rng.integers(0, 16, size=(300,)).astype(np.int32)
    else:
        keys = rng.normal(size=(300,)).astype(np.float32)
    values = np.arange(300, dtype=np.int32)
    wk, wv = jref.sort_kv_ref(jnp.asarray(keys), jnp.asarray(values))
    tk, tv = tref.sort_kv_ref(*from_reference([keys, values], "cpu"))
    # Stable: equal keys keep their input order, so values match exactly too.
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("op", sorted(ops.KERNEL_OPS))
def test_tune_space_contract(op):
    space = ops.tune_space(op)
    assert isinstance(space, tuple) and space
    for cand in space:
        assert isinstance(cand, dict)
        for key, value in cand.items():
            assert isinstance(key, str)
            assert type(value) is int and value > 0
    # The first entry is the kernel's defaults: the CUDA entry point's
    # keyword defaults.
    launcher = {"matmul": tmatmul.matmul_cuda, "softmax": tsoftmax.softmax_cuda}[op]
    params = inspect.signature(launcher).parameters
    assert space[0] == {k: params[k].default for k in space[0]}


def test_kernel_ops_lists_only_ported_kernels():
    assert set(ops.KERNEL_OPS) == {"matmul", "softmax"}
    with pytest.raises(KeyError, match="unknown kernel op"):
        ops.tune_space("attention")


def test_cuda_entry_points_raise_cleanly_on_cpu_tensors():
    a = torch.ones(4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tmatmul.matmul_cuda(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        tsoftmax.softmax_cuda(a)
    # The kernel route on CPU tensors runs the plain version, counts it as
    # such, and launches nothing.
    launches, plain = dict(tmatmul.launches), tmatmul.plain_calls
    out = ops.matmul(a, a, mode="kernel")
    torch.testing.assert_close(out, a @ a)
    assert tmatmul.launches == launches
    assert tmatmul.plain_calls == plain + 1


def test_matmul_layout_check_takes_views_and_refuses_other_strides():
    base = torch.zeros(6, 8)
    assert tmatmul._strides(base, "a") == (8, 1)
    assert tmatmul._strides(base.T, "a") == (1, 8)  # the gemm "tn" view
    with pytest.raises(ValueError, match="row- or column-major"):
        tmatmul._strides(base[:, ::2], "a")


def test_force_impl_governs_auto_calls_only():
    a = torch.ones(3, 3)
    plain = tmatmul.plain_calls
    ops.matmul(a, a)  # auto on a CPU tensor: the oracle, not the kernel route
    assert tmatmul.plain_calls == plain
    with ops.force_impl("kernel", "matmul"):
        ops.matmul(a, a)
        ops.matmul(a, a, mode="ref")  # an explicit mode wins
    assert tmatmul.plain_calls == plain + 1
    with pytest.raises(ValueError, match="mode"):
        with ops.force_impl("pallas"):
            pass


def test_force_impl_params_reach_only_the_named_op(monkeypatch):
    seen = {}
    monkeypatch.setattr(tmatmul, "matmul_kernel", lambda a, b, **kw: seen.setdefault("mm", kw))
    monkeypatch.setattr(tsoftmax, "softmax_kernel", lambda x: seen.setdefault("sm", {}))
    x = torch.ones(2, 2)
    with ops.force_impl("kernel", "matmul", block_m=64, block_n=64):
        ops.matmul(x, x, block_n=128)  # call-site blocks win over forced ones
        ops.softmax(x)
    assert seen == {"mm": {"block_m": 64, "block_n": 128}, "sm": {}}


def test_peaks_are_keyed_by_card_name():
    assert metrics.peaks_for("NVIDIA H100 PCIe") is metrics.H100_PCIE
    assert metrics.peaks_for(None) is metrics.H100_SXM  # a CPU run's target
    with pytest.raises(ValueError, match="no peak table row"):
        metrics.peaks_for("NVIDIA H100 NVL")


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    monkeypatch.setattr(_build, "_LOADED", None)
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.library()


def test_convert_carries_bf16_through_f32_exactly(rng):
    x = jnp.asarray(rng.normal(size=(5, 7)), jnp.bfloat16)
    arr = np.asarray(x)
    assert arr.dtype.name == "bfloat16"
    (t,) = from_reference([arr], "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), arr.astype(np.float32))
