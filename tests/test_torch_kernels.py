"""The port's kernel layer against the JAX reference, on the CPU.

The same numpy-seeded inputs go through the reference (its Pallas kernels in
interpret mode, or its ``ref.py`` oracles) and through the port (the kernel
route, which runs the plain version for CPU tensors, or the port's oracles),
at the reference's own test shapes and tolerances. The CUDA kernels
themselves run only on a card: ``chip_smoke.py`` and ``test_torch_cuda.py``
hold them against these plain versions there.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.avgpool import avgpool_pallas
from repro.kernels.bitonic_sort import bitonic_sort_pallas
from repro.kernels.lrn import lrn_pallas
from repro.kernels.matmul import matmul_pallas
from repro.kernels.prefix_scan import prefix_scan_pallas
from repro.kernels.softmax import softmax_pallas
from repro.kernels.srad_stencil import srad_step_fused, srad_step_split
from repro_torch.convert import from_reference
from repro_torch.core import metrics
from repro_torch.kernels import _build, ops
from repro_torch.kernels import avgpool as tavgpool
from repro_torch.kernels import bitonic_sort as tsort
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import lrn as tlrn
from repro_torch.kernels import matmul as tmatmul
from repro_torch.kernels import prefix_scan as tscan
from repro_torch.kernels import ref as tref
from repro_torch.kernels import softmax as tsoftmax
from repro_torch.kernels import srad_stencil as tsrad

# tests/test_kernels_matmul.py:11-17 and tests/test_kernels_misc.py:17-18,29-30,38
MATMUL_SHAPES = [(8, 8, 8), (128, 128, 128), (130, 70, 50), (1, 256, 33), (257, 1, 128)]
SOFTMAX_SHAPES = [(1, 8), (33, 257), (64, 64), (7, 1031)]
LRN_SHAPES = [(1, 5, 4, 4), (2, 13, 9, 11), (3, 64, 8, 8)]
AVGPOOL_CASES = [((1, 3, 4, 4), 2), ((2, 5, 8, 12), 2), ((1, 8, 9, 9), 3)]
# tests/test_kernels_misc.py:46,55,63
SRAD_SHAPES = [(8, 8), (32, 48), (65, 33)]
SCAN_CASES = [(8, 8), (1000, 128), (4096, 512), (5, 3)]
SORT_SIZES = [2, 8, 64, 1024]
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


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (130, 70, 50), (1, 256, 33)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared", ["shared_a", "both_batched"])
def test_batched_matmul_kernel_route_matches_vmapped_pallas(rng, m, k, n, dtype, shared):
    """Convolution's im2col path: the reference vmaps the Pallas GEMM over a
    batch; the port makes one batched call of its kernel route."""
    batch = 3
    a_shape = (m, k) if shared == "shared_a" else (batch, m, k)
    a = jnp.asarray(rng.normal(size=a_shape).astype(np.float32)).astype(dtype)
    b = jnp.asarray(rng.normal(size=(batch, k, n)).astype(np.float32)).astype(dtype)

    def one(x, y):
        return matmul_pallas(x, y, block_m=64, block_n=64, block_k=32, interpret=True)

    in_axes = (None, 0) if shared == "shared_a" else (0, 0)
    want = jax.vmap(one, in_axes=in_axes)(a, b)
    ta, tb = from_reference([np.asarray(a), np.asarray(b)], "cpu")
    got = ops.matmul(ta, tb, mode="kernel")
    assert got.dtype == ta.dtype and tuple(got.shape) == (batch, m, n)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("n,c,h,w", LRN_SHAPES)
@pytest.mark.parametrize("size", [3, 5])
def test_lrn_kernel_route_matches_pallas(rng, n, c, h, w, size):
    x = jnp.asarray(rng.normal(size=(n, c, h, w)).astype(np.float32))
    want = lrn_pallas(x, size=size, block_s=16, interpret=True)
    (tx,) = from_reference([np.asarray(x)], "cpu")
    got = ops.lrn(tx, size=size, mode="kernel")
    assert got.dtype == tx.dtype and got.shape == tx.shape
    # tests/test_kernels_misc.py:35
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,ks", AVGPOOL_CASES)
def test_avgpool_kernel_route_matches_pallas(rng, shape, ks):
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    want = avgpool_pallas(x, ksize=ks, block_c=4, interpret=True)
    (tx,) = from_reference([np.asarray(x)], "cpu")
    got = ops.avgpool(tx, ksize=ks, mode="kernel")
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    # tests/test_kernels_misc.py:43
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h,w", SRAD_SHAPES)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_srad_kernel_route_matches_pallas(rng, h, w, fused):
    img = jnp.asarray(rng.uniform(0.2, 1.0, size=(h, w)).astype(np.float32))
    want = (srad_step_fused if fused else srad_step_split)(img, interpret=True)
    (timg,) = from_reference([np.asarray(img)], "cpu")
    plain = tsrad.plain_calls
    got = ops.srad_step(timg, fused=fused, mode="kernel")
    assert tsrad.plain_calls == plain + 1
    assert got.dtype == timg.dtype and got.shape == timg.shape
    # tests/test_kernels_misc.py:52
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,bn", SCAN_CASES)
def test_prefix_scan_kernel_route_matches_pallas(rng, n, bn):
    x = jnp.asarray(rng.normal(size=(n,)).astype(np.float32))
    want = prefix_scan_pallas(x, block_n=bn, interpret=True)
    (tx,) = from_reference([np.asarray(x)], "cpu")
    got = ops.prefix_scan(tx, mode="kernel")
    assert got.dtype == tx.dtype and got.shape == tx.shape
    # tests/test_kernels_misc.py:60
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", SORT_SIZES)
def test_sort_kernel_route_matches_pallas(rng, n):
    keys = jnp.asarray(rng.integers(0, 1 << 20, n).astype(np.int32))
    vals = jnp.arange(n, dtype=jnp.int32)
    ko, vo = bitonic_sort_pallas(keys, vals, interpret=True)
    tk, tv = from_reference([np.asarray(keys), np.asarray(vals)], "cpu")
    gk, gv = ops.sort_kv(tk, tv, mode="kernel")
    assert gk.dtype == torch.int32 and gv.dtype == torch.int32
    np.testing.assert_array_equal(gk.numpy(), np.asarray(ko))
    # Same pairing: keys[vo] == ko (tests/test_kernels_misc.py:71-72).
    np.testing.assert_array_equal(np.asarray(keys)[gv.numpy()], gk.numpy())
    # Stable, as the reference's oracle: equal keys keep their input order.
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jref.sort_kv_ref(keys, vals)[1]))


def test_sort_kernel_route_matches_pallas_on_float_keys(rng):
    keys = jnp.asarray(rng.normal(size=(256,)).astype(np.float32))
    vals = jnp.arange(256, dtype=jnp.int32)
    ko, _ = bitonic_sort_pallas(keys, vals, interpret=True)
    tk, tv = from_reference([np.asarray(keys), np.asarray(vals)], "cpu")
    gk, gv = ops.sort_kv(tk, tv, mode="kernel")
    assert np.all(np.diff(gk.numpy()) >= 0)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(ko))
    np.testing.assert_array_equal(np.asarray(keys)[gv.numpy()], gk.numpy())


def test_sort_kv_needs_no_padding_at_a_ragged_length(rng):
    """1000 is no power of two: the reference pads to 1024 with the largest
    key and slices back; the port's kernel route sorts the 1000 as they are."""
    keys = jnp.asarray(rng.integers(0, 1 << 20, 1000).astype(np.int32))
    vals = jnp.asarray(rng.permutation(1000).astype(np.int32))
    ko, vo = jops.sort_kv(keys, vals, mode="pallas")
    tk, tv = from_reference([np.asarray(keys), np.asarray(vals)], "cpu")
    gk, gv = ops.sort_kv(tk, tv, mode="kernel")
    assert tuple(gk.shape) == tuple(gv.shape) == (1000,)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(ko))
    # Both carry each key's own value (the values are distinct).
    pair = dict(zip(np.asarray(vals).tolist(), np.asarray(keys).tolist()))
    assert [pair[v] for v in gv.numpy().tolist()] == gk.numpy().tolist()
    assert [pair[v] for v in np.asarray(vo).tolist()] == np.asarray(ko).tolist()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_prefix_scan_kernel_route_refuses_uncompiled_blocks_before_dispatch(device):
    x = torch.zeros(100, device=device)
    plain = tscan.plain_calls
    for bn in (8, 512, 1024, 3000, 4096):
        with pytest.raises(ValueError, match="block_n"):
            ops.prefix_scan(x, block_n=bn, mode="kernel")
    assert tscan.plain_calls == plain
    space = tscan.tune_space()
    assert space == ({"block_n": 2048},)  # the reference's key and default
    for cand in space:  # every candidate the tune stage may pick
        if device == "cpu":
            ops.prefix_scan(x, mode="kernel", **cand)
    assert tscan.plain_calls == plain + (len(space) if device == "cpu" else 0)


def test_new_cuda_entry_points_raise_cleanly_on_cpu_tensors():
    img, x, k = torch.ones(8, 8), torch.ones(100), torch.ones(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tsrad.srad_step_cuda(img)
    with pytest.raises(ValueError, match="CUDA"):
        tsrad.srad_step_cuda(img, fused=False)
    with pytest.raises(ValueError, match="CUDA"):
        tsrad.srad_phase2_cuda(img, img)
    with pytest.raises(ValueError, match="CUDA"):
        tscan.prefix_scan_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        tsort.sort_kv_cuda(k, k)
    # The kernel route on CPU tensors runs the plain version, counts it as
    # such, and launches nothing.
    mods = (tsrad, tscan, tsort)
    launches = [dict(m.launches) for m in mods]
    plain = [m.plain_calls for m in mods]
    torch.testing.assert_close(ops.srad_step(img, mode="kernel"), tref.srad_step_ref(img))
    ops.srad_step(img, fused=False, mode="kernel")
    torch.testing.assert_close(ops.prefix_scan(x, mode="kernel"), torch.cumsum(x, 0))
    ko, vo = ops.sort_kv(k, torch.arange(10, dtype=torch.int32), mode="kernel")
    assert torch.equal(vo, torch.arange(10, dtype=torch.int32))  # stable on ties
    assert [dict(m.launches) for m in mods] == launches
    assert [m.plain_calls for m in mods] == [plain[0] + 2, plain[1] + 1, plain[2] + 1]


def test_srad_phases_compose_to_the_plain_step(rng):
    img = torch.from_numpy(rng.uniform(0.2, 1.0, size=(13, 17)).astype(np.float32))
    c = tsrad.srad_phase1_plain(img, q0sqr=0.1)
    assert c.dtype == torch.float32 and bool(((c >= 0) & (c <= 1)).all())
    torch.testing.assert_close(
        tsrad.srad_phase2_plain(img, c, lam=0.25),
        tref.srad_step_ref(img, lam=0.25, q0sqr=0.1), rtol=0, atol=0,
    )


def test_srad_scalars_are_rounded_as_the_plain_version_rounds_them():
    q0, inv_qden = tsrad._coeff_scalars(0.05)
    assert q0 == float(np.float32(0.05))
    assert inv_qden == float(np.float32(1.0) / np.float32(0.05 * 1.05))
    assert tsrad._update_scalar(0.5) == 0.125


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_lrn_kernel_route_refuses_even_size_before_dispatch(device):
    """The reference's kernel sums size+1 channels for an even size and its
    oracle size: the port's kernel route refuses even sizes on any device,
    before it picks the kernel or the plain version."""
    x = torch.zeros(2, 8, 4, 4, device=device)
    plain = tlrn.plain_calls
    for size in (2, 4):
        with pytest.raises(ValueError, match="odd window size"):
            ops.lrn(x, size=size, mode="kernel")
    assert tlrn.plain_calls == plain
    if device == "cpu":
        ops.lrn(x, size=3, mode="kernel")  # an odd size goes on to the plain version
        assert tlrn.plain_calls == plain + 1


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_avgpool_kernel_route_refuses_untiled_windows_before_dispatch(device):
    plain = tavgpool.plain_calls
    for shape, ks in (((1, 2, 9, 8), 2), ((1, 2, 8, 10), 3), ((1, 2, 8, 8), 0)):
        with pytest.raises(ValueError, match="divisible by ksize"):
            ops.avgpool(torch.zeros(shape, device=device), ksize=ks, mode="kernel")
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        ops.avgpool(torch.zeros(4, 4, device=device), mode="kernel")
    assert tavgpool.plain_calls == plain


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
    launcher = {
        "matmul": tmatmul.matmul_cuda,
        "attention": tfa.flash_attention_cuda,
        "softmax": tsoftmax.softmax_cuda,
        "lrn": tlrn.lrn_cuda,
        "avgpool": tavgpool.avgpool_cuda,
        "srad_step": tsrad.srad_step_cuda,
        "prefix_scan": tscan.prefix_scan_cuda,
        "sort_kv": tsort.sort_kv_cuda,
    }[op]
    params = inspect.signature(launcher).parameters
    assert space[0] == {k: params[k].default for k in space[0]}


def test_kernel_ops_lists_only_ported_kernels():
    # Every TPU kernel of the reference now has a Hopper counterpart.
    assert set(ops.KERNEL_OPS) == {
        "matmul", "attention", "softmax", "lrn", "avgpool", "srad_step", "prefix_scan",
        "sort_kv",
    }
    assert set(ops.KERNEL_OPS) == set(jops.PALLAS_OPS)
    with pytest.raises(KeyError, match="unknown kernel op"):
        ops.tune_space("flash_attention")


def test_cuda_entry_points_raise_cleanly_on_cpu_tensors():
    a, x = torch.ones(4, 4), torch.ones(1, 4, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tmatmul.matmul_cuda(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        tmatmul.matmul_cuda(torch.ones(2, 4, 4), torch.ones(2, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tsoftmax.softmax_cuda(a)
    with pytest.raises(ValueError, match="CUDA"):
        tlrn.lrn_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        tavgpool.avgpool_cuda(x)
    # The kernel route on CPU tensors runs the plain version, counts it as
    # such, and launches nothing.
    mods = (tmatmul, tlrn, tavgpool)
    launches = [dict(m.launches) for m in mods]
    plain = [m.plain_calls for m in mods]
    out = ops.matmul(a, a, mode="kernel")
    torch.testing.assert_close(out, a @ a)
    ops.matmul(a, torch.ones(2, 4, 4), mode="kernel")
    ops.lrn(x, mode="kernel")
    ops.avgpool(x, mode="kernel")
    assert [dict(m.launches) for m in mods] == launches
    assert [m.plain_calls for m in mods] == [plain[0] + 2, plain[1] + 1, plain[2] + 1]


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


def _bf(*shape):
    return torch.empty(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("layout", ["nn", "tn"])
def test_matmul_route_sends_the_paths_bf16_products_to_the_tma_kernel(layout):
    """The GEMM and MaxFlops bf16 rows at preset 4 (4096^3; "tn" hands the
    kernel a.T) go to the TMA + wgmma kernel, a batch of 1 too."""
    n = 4096
    a = _bf(n, n) if layout == "nn" else _bf(n, n).T
    b = _bf(n, n)
    assert tmatmul._route(a, b) == "matmul_bf16"
    assert tmatmul._route(a[None], b) == "matmul_bf16"
    # (a_m_major, lda, sab, ldb, sbb): 2-D operands, batch strides 0.
    assert tmatmul._tma_operands(a, b) == (int(layout == "tn"), n, 0, n, 0)
    assert tmatmul._route(a.float(), b.float()) == "matmul_f32"


def test_matmul_route_keeps_the_wmma_kernel_for_other_bf16_layouts():
    wmma = "matmul_bf16_wmma"
    assert tmatmul._route(_bf(1, 256), _bf(256, 33)) == wmma  # B's row stride 33
    assert tmatmul._route(_bf(130, 70), _bf(70, 50)) == wmma  # row strides 70 and 50
    ragged = _bf(200).as_strided((3, 8, 8), (68, 8, 1))  # batch stride 68
    assert tmatmul._route(ragged, _bf(3, 8, 8)) == wmma  # a batch
    assert tmatmul._route(_bf(8, 8), ragged) == wmma  # a broadcast batch
    assert tmatmul._route(_bf(8, 8), _bf(8, 8).T) == wmma  # column-major B
    odd = _bf(1 + 64 * 64)[1:].view(64, 64)  # one element into its storage
    assert odd.data_ptr() % 16 != 0
    assert tmatmul._route(odd, _bf(64, 64)) == wmma
    assert tmatmul._route(_bf(64, 64), odd) == wmma
    assert tmatmul._route(_bf(64, 64), _bf(64, 64)) == "matmul_bf16"


def test_matmul_route_refuses_what_no_entry_takes():
    with pytest.raises(ValueError, match="row- or column-major"):
        tmatmul._route(_bf(8, 16)[:, ::2], _bf(8, 8))
    with pytest.raises(ValueError, match="float32 or two bfloat16"):
        tmatmul._route(torch.ones(4, 4).half(), torch.ones(4, 4).half())
    with pytest.raises(ValueError, match="batches differ"):
        tmatmul._route(_bf(3, 4, 4), _bf(2, 4, 4))
    launches = dict(tmatmul.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tmatmul.matmul_cuda(_bf(8, 8), _bf(8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tmatmul._launch("matmul_bf16_wmma", _bf(8, 8), _bf(8, 8))
    assert tmatmul.launches == launches
