"""The kernel ops' batching rules against ``jax.vmap`` of the reference's
ops, on the CPU.

Under ``torch.vmap`` a kernel op hands its batched call to its batching rule
(``repro_torch/kernels/ops.py``): one launch of the kernel over the folded
batch (matmul, attention, softmax, lrn, avgpool), or one launch a member
(prefix_scan, sort_kv, srad_step). On the CPU the rule runs over the plain
versions, so these tests reach the rule itself. The same numpy-seeded
members go through ``torch.vmap`` of the port's kernel route, through the
port's plain version one member at a time, and through ``jax.vmap`` of the
reference's op in interpret mode (its Pallas kernel batched by Pallas's
rule), at the reference's tolerances (1e-5 f32, 2e-2 bf16, 2e-4 f32
attention, 1e-4 the f32 scan; the sort exactly). Two cases use the
reference's ``ref`` mode instead: a batch of 3-D matmul operands (its
Pallas GEMM takes 2-D ones only) and the sort, whose bitonic network is not
stable (equal keys may carry their values in another order; its oracle is
stable, as the port's kernel is).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.convert import from_reference
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

W = 3  # members a batched call


def _cases(rng):
    f32 = np.float32

    def n(*shape):
        return rng.normal(size=(W, *shape)).astype(f32)

    bf = jnp.bfloat16
    return {
        # op, members' inputs, keyword arguments, in_dims, tolerance, the
        # reference's mode
        "matmul_f32": ("matmul", (n(130, 70), n(70, 50)), {}, (0, 0), 1e-5, "pallas"),
        "matmul_f32_shared_b": ("matmul", (n(33, 64), n(64, 40)[0]), {}, (0, None), 1e-5,
                                "pallas"),
        "matmul_f32_batched_a": ("matmul", (n(2, 16, 24), n(24, 8)[0]), {}, (0, None), 1e-5,
                                 "ref"),
        "matmul_bf16": ("matmul", (np.asarray(jnp.asarray(n(64, 48), bf)),
                                   np.asarray(jnp.asarray(n(48, 40), bf))), {}, (0, 0), 2e-2,
                        "pallas"),
        "attention": ("attention", (n(2, 4, 5, 8), n(2, 2, 7, 8), n(2, 2, 7, 8)),
                      {"causal": True, "window": 3}, (0, 0, 0), 2e-4, "pallas"),
        "softmax": ("softmax", (5 * n(33, 257),), {}, (0,), 1e-5, "pallas"),
        "lrn": ("lrn", (n(2, 13, 9, 11),), {"size": 5}, (0,), 1e-5, "pallas"),
        "avgpool": ("avgpool", (n(2, 5, 8, 12),), {"ksize": 2}, (0,), 1e-6, "pallas"),
        "prefix_scan": ("prefix_scan", (n(1000),), {}, (0,), 1e-4, "pallas"),
        "sort_kv": ("sort_kv", (rng.integers(0, 16, size=(W, 256)).astype(np.int32),
                                np.tile(np.arange(256, dtype=np.int32), (W, 1))),
                    {}, (0, 0), 0.0, "ref"),
        "srad_step": ("srad_step", (rng.uniform(0.2, 1.0, size=(W, 32, 48)).astype(f32),),
                      {}, (0,), 1e-5, "pallas"),
    }


CASES = ["matmul_f32", "matmul_f32_shared_b", "matmul_f32_batched_a", "matmul_bf16",
         "attention", "softmax", "lrn", "avgpool", "prefix_scan", "sort_kv", "srad_step"]
# Rules without a batch axis in their kernel: one plain call a member.
LOOPED = {"prefix_scan", "sort_kv", "srad_step"}


def _np32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("case", CASES)
def test_each_ops_batching_rule_matches_jax_vmap_of_the_reference(rng, case, monkeypatch):
    op, args, kwargs, in_dims, tol, ref_mode = _cases(rng)[case]
    reached = []
    rule = ops._RULES[op]
    monkeypatch.setitem(ops._RULES, op,
                        lambda w, dims, *a: reached.append((w, dims)) or rule(w, dims, *a))
    targs = from_reference(args, "cpu")
    module = ops.KERNEL_OPS[op]
    plain = module.plain_calls
    with ops.force_impl("kernel"):
        got = _tuple(torch.vmap(lambda *xs: getattr(ops, op)(*xs, **kwargs),
                                in_dims=in_dims)(*targs))
    assert reached == [(W, in_dims)]  # the rule ran, once, over the whole batch
    assert module.plain_calls - plain == (W if op in LOOPED else 1)
    want = _tuple(jax.vmap(lambda *xs: getattr(jops, op)(*xs, mode=ref_mode, **kwargs),
                           in_axes=in_dims)(*[jnp.asarray(a) for a in args]))
    for j in range(W):
        member = [t if d is None else t[j] for t, d in zip(targs, in_dims)]
        one = _tuple(getattr(tref, f"{op}_ref")(*member, **kwargs))
        for g, p, r in zip(got, one, want):
            assert g.dtype == p.dtype and tuple(g[j].shape) == tuple(p.shape)
            np.testing.assert_allclose(_np32(g[j]), _np32(p), rtol=tol, atol=tol)
            np.testing.assert_allclose(_np32(g[j]), _np32(r[j]), rtol=tol, atol=tol)


def test_an_unbatched_call_never_reaches_a_rule(monkeypatch):
    monkeypatch.setattr(ops, "_RULES", {})
    x = torch.randn(4, 8)
    with ops.force_impl("kernel"):
        torch.testing.assert_close(ops.softmax(x), tref.softmax_ref(x))
        torch.testing.assert_close(ops.matmul(x, x.T), tref.matmul_ref(x, x.T))


def test_nested_vmap_reaches_the_rule_at_each_level():
    x = torch.randn(2, 3, 5, 16)
    with ops.force_impl("kernel"):
        got = torch.vmap(torch.vmap(ops.softmax))(x)
    torch.testing.assert_close(got, tref.softmax_ref(x))
