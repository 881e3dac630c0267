#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU — the quickest proof that
the port still builds and runs on the card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check raises and the script
exits nonzero without printing its result line:

1. card: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` compiled by nvcc;
3. kernels against their plain versions on the card, at the reference's
   test shapes, at ragged shapes and at the main paths' shapes, with the
   stated tolerances;
4. the main path: the port's suite at preset 4 with ``--impl kernel`` over
   the 8 benchmarks of the first slice (forward), with every launch counter
   set to 0 just before and read just after (each kernel must have
   launched, exactly as often as the engine's stages call it);
4a. the DNN section: the same at preset 4 over Convolution (both paths),
   LRN, Pooling, Activation, Batchnorm, RNN and Dropout, forward and
   backward, counters again set to 0 just before and read just after;
4b. the kernel rows of both paths at preset 0, kernel against torch on the
   same inputs, f32 products against an f64 evaluation;
5. yardstick: each kernel of the paths, its plain version and the one
   PyTorch call that computes the same function, timed with CUDA events at
   the paths' shapes, beside the card's bound for the same work.

It prints a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. It needs a CUDA card and the rest of the
repository: without either it exits 1.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN_PATH = (
    "gemm_f32_nn", "gemm_f32_tn", "gemm_bf16_nn", "gemm_bf16_tn",
    "maxflops_bf16", "maxflops_f32", "connected", "softmax",
)
DNN_PATH = (
    "convolution_xla", "convolution_im2col", "lrn", "pooling", "activation",
    "batchnorm", "rnn", "dropout",
)
# The DNN benchmarks that reach a kernel, and the kernel (launch counter).
DNN_KERNELS = {
    "convolution_im2col": "matmul_f32_batched", "lrn": "lrn_f32", "pooling": "avgpool_f32",
}
PRESET, ITERS, WARMUP, WINDOW = 4, 5, 2, 4
# Calls of each pass's function on the main path: the compile stage's first
# call, the validation call, the sync-mode warm-up and timed calls, and the
# windowed calls.
CALLS_PER_PASS = 1 + 1 + WARMUP + ITERS + ITERS * WINDOW
U_F32 = 2.0**-24  # unit round-off of f32
SMALL_SHAPES = [(8, 8, 8), (128, 128, 128), (130, 70, 50), (1, 256, 33), (257, 1, 128)]
SOFTMAX_SMALL = [(1, 8), (33, 257), (64, 64), (7, 1031)]
REF_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_kernels_*.py
# The reference's LRN and avgpool test shapes (tests/test_kernels_misc.py:
# 29-43), ragged ones (C not a multiple of the 32-channel chunk, S not a
# multiple of the 128-position block; an output count not a multiple of the
# 256-thread block), the largest window, and the DNN presets' shapes.
LRN_CASES = [
    ((1, 5, 4, 4), 3), ((1, 5, 4, 4), 5), ((2, 13, 9, 11), 3), ((2, 13, 9, 11), 5),
    ((3, 64, 8, 8), 3), ((3, 64, 8, 8), 5), ((3, 45, 13, 11), 7), ((2, 100, 5, 7), 65),
]
LRN_PRESET4 = (128, 512, 16, 16)
AVGPOOL_CASES = [((1, 3, 4, 4), 2), ((2, 5, 8, 12), 2), ((1, 8, 9, 9), 3), ((3, 7, 30, 18), 2)]
AVGPOOL_PRESET4 = (128, 256, 32, 32)
CONV_PRESET4 = (64, 256, 2304, 900)  # images, O, C*KH*KW, OH*OW
GEMM_N = 4096  # gemm_* and maxflops_* at preset 4
CONNECTED_PRESET4 = (1024, 4096, 4096)  # batch, din, dout
SOFTMAX_PRESET4 = (32768, 16384)  # batch, classes
KERNEL_SOURCES = {
    "matmul_f32": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:55"),
    "matmul_bf16": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:55"),
    "softmax_f32": ("src/repro_torch/kernels/csrc/softmax.cu", "src/repro/kernels/softmax.py:68"),
    "matmul_f32_batched": ("src/repro_torch/kernels/csrc/matmul.cu",
                           "src/repro/kernels/matmul.py:55"),
    "lrn_f32": ("src/repro_torch/kernels/csrc/lrn.cu", "src/repro/kernels/lrn.py:39"),
    "avgpool_f32": ("src/repro_torch/kernels/csrc/avgpool.cu",
                    "src/repro/kernels/avgpool.py:34"),
}


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _dtname(dt) -> str:
    return str(dt).replace("torch.", "")


def _kernel_modules():
    from repro_torch.kernels import avgpool, lrn, matmul, softmax

    return (matmul, softmax, lrn, avgpool)


def _zero_launches() -> None:
    for mod in _kernel_modules():
        for key in mod.launches:
            mod.launches[key] = 0


def _read_launches() -> dict:
    return {k: v for mod in _kernel_modules() for k, v in mod.launches.items()}


def _rms(t) -> float:
    return t.double().square().mean().sqrt().item()


def phase_card(torch) -> str:
    from repro_torch.core.results import gpu_name_and_power_limit

    smi = gpu_name_and_power_limit()
    if smi is None:
        _fail("nvidia-smi did not report the card")
    print("== phase 1: card")
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} name {torch.cuda.get_device_name(0)}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    print("== phase 2: build")
    info = _build.build_info()
    print(f"built {info['path']} in {info['seconds']:.2f} s (reused: {info['cached']})")
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())


def _exact_check(out, plain, exact, k, sigma, dt, chain=1):
    """Kernel and plain outputs against an exact (f64) evaluation.

    f64 holds every product of two f32 or bf16 inputs exactly and sums K of
    them far below f32's round-off. The kernel adds the K products one after
    another in f32; each rounding errs by at most u times the running sum,
    whose rms after k terms is sqrt(k)*sigma (sigma = rms(A)*rms(B)), so the
    error's rms is about u*sigma*K/sqrt(12). Outputs far from zero carry
    larger running sums and larger errors: on an H100 the largest of 16M
    outputs came to 4.7*u*sigma*K (1.15e-3 at unit inputs, K=4096), for
    cuBLAS's f32 product too. ATOL = 16*u*K*sigma (3.9e-3 there) leaves 3.4x
    on that, while a kernel that rounded its inputs to TF32 (2^-11) or bf16
    errs by about sqrt(K)*2^-11*sigma*0.8 ~ 0.026 on a typical output (0.25
    at most) and fails. A chain of products (MaxFlops) repeats the error
    once per link, so the bound is ``chain`` times that. A bf16 output adds
    its own rounding, 2^-8 of the value. Both sides within ATOL (+ rounding)
    of the exact value are within twice that of each other; two bf16
    roundings differ by at most one bf16 ulp, 2^-7 of the value.

    Returns (ok, line, max abs kernel - plain).
    """
    import torch

    atol = 16 * k * U_F32 * sigma * chain
    rtol = 0.0 if dt == torch.float32 else 2.0**-8
    out, plain = out.double(), plain.double()
    err = (out - exact).abs()
    plain_err = (plain - exact).abs()
    diff = (out - plain).abs()
    ok = (
        bool((err <= atol + rtol * exact.abs()).all())
        and bool((plain_err <= atol + rtol * exact.abs()).all())
        and bool((diff <= 2 * atol + 2 * rtol * plain.abs()).all())
        and bool(torch.isfinite(out).all())
    )
    chain_txt = f"*{chain}" if chain > 1 else ""
    line = (f"vs f64: kernel max_abs {err.max().item():.3e}, plain max_abs "
            f"{plain_err.max().item():.3e} [16*K*u*sigma{chain_txt} = {atol:.3e}, "
            f"rtol {rtol:g}]; vs plain max_abs {diff.max().item():.3e} [2x that]")
    return ok, line, diff.max().item()


def _matmul_case(torch, matmul, gen, dt, m, k, n, trans):
    if trans == "tn":  # the gemm "tn" specs hand the kernel a.T, a strided view
        a = torch.randn(k, m, generator=gen, device="cuda").to(dt).T
    else:
        a = torch.randn(m, k, generator=gen, device="cuda").to(dt)
    b = torch.randn(k, n, generator=gen, device="cuda").to(dt)
    out = matmul.matmul_cuda(a, b).float()
    torch.cuda.synchronize()
    plain = matmul.matmul_plain(a, b).float()
    diff = (out - plain).abs()
    if max(m, k, n) <= 512:
        atol = rtol = REF_TOL[_dtname(dt)]
        ok = bool((diff <= atol + rtol * plain.abs()).all())
        print(f"  matmul {_dtname(dt):8s} {trans} ({m},{k},{n}) max_abs "
              f"{diff.max().item():.3e} [reference tolerance {atol:g} abs and rel] "
              f"{'ok' if ok else 'FAIL'}")
    else:
        exact = torch.matmul(a.double(), b.double())
        ok, line, _ = _exact_check(out, plain, exact, k, _rms(a) * _rms(b), dt)
        print(f"  matmul {_dtname(dt):8s} {trans} ({m},{k},{n}) {line} "
              f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"matmul {dt} {trans} {(m, k, n)} disagrees with its plain version")
    return diff.max().item()


def _batched_matmul_case(torch, matmul, gen, dt, batch, m, k, n, shared):
    """Convolution's im2col product: a shared (M, K) weight (or a batch of
    them) times a batch of (K, N) patch matrices, one launch."""
    a = torch.randn(*(() if shared else (batch,)), m, k, generator=gen, device="cuda").to(dt)
    b = torch.randn(batch, k, n, generator=gen, device="cuda").to(dt)
    key = f"matmul_{'f32' if dt == torch.float32 else 'bf16'}_batched"
    before = matmul.launches[key]
    out = matmul.matmul_cuda(a, b).float()
    torch.cuda.synchronize()
    if matmul.launches[key] != before + 1 or tuple(out.shape) != (batch, m, n):
        _fail(f"batched matmul {dt}: shape {tuple(out.shape)}, counted under {key} "
              f"{matmul.launches[key] - before} times")
    plain = matmul.matmul_plain(a, b).float()
    what = f"batched matmul {_dtname(dt):8s} {'shared a' if shared else 'both'} " \
           f"{batch}x({m},{k},{n})"
    if max(m, k, n) <= 512:
        atol = rtol = REF_TOL[_dtname(dt)]
        diff = (out - plain).abs()
        ok = bool((diff <= atol + rtol * plain.abs()).all())
        line, max_diff = (f"max_abs {diff.max().item():.3e} [reference tolerance "
                          f"{atol:g} abs and rel]"), diff.max().item()
    else:
        exact = torch.matmul(a.double(), b.double())
        ok, line, max_diff = _exact_check(out, plain, exact, k, _rms(a) * _rms(b), dt)
    print(f"  {what} {line} {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"{what} disagrees with its plain version")
    return max_diff


def _softmax_agrees(out, want, dt):
    """Softmax outputs compared by relative error: ``|out - want| <=
    tol*|want| + 1e-30`` with the reference's tolerance as ``tol``. In a row
    of 5*randn logits most outputs lie far below 1e-5, so an absolute term
    of the reference's size would let them be anything. The 1e-30 only
    spares outputs that underflow. Returns (ok, max_abs, max_rel), max_rel
    unclamped (inf where the plain version gives 0 and the kernel does not).
    """
    tol = REF_TOL[_dtname(dt)]
    out, want = out.float(), want.float()
    diff = (out - want).abs()
    ok = bool((diff <= tol * want.abs() + 1e-30).all())
    rel = (diff / want.abs()).nan_to_num(nan=0.0, posinf=float("inf"))
    return ok, diff.max().item(), rel.max().item()


def _softmax_case(torch, softmax, gen, dt, r, c, scale=5.0):
    x = (scale * torch.randn(r, c, generator=gen, device="cuda")).to(dt)
    out = softmax.softmax_cuda(x)
    torch.cuda.synchronize()
    ok, max_abs, max_rel = _softmax_agrees(out, softmax.softmax_plain(x), dt)
    print(f"  softmax {_dtname(dt):8s} ({r},{c}) logits {scale:g}*randn max_abs "
          f"{max_abs:.3e} max_rel {max_rel:.3e} [rtol {REF_TOL[_dtname(dt)]:g}, "
          f"atol 1e-30] {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"softmax {dt} {(r, c)} disagrees with its plain version")
    return max_abs


def _close_case(torch, what, out, want, rtol, atol):
    """Kernel output against its plain version at the reference's
    tolerances, ``|out - want| <= atol + rtol*|want|``."""
    torch.cuda.synchronize()
    diff = (out - want).abs()
    ok = (out.shape == want.shape and bool(torch.isfinite(out).all())
          and bool((diff <= atol + rtol * want.abs()).all()))
    print(f"  {what} max_abs {diff.max().item():.3e} [rtol {rtol:g}, atol {atol:g}] "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"{what} disagrees with its plain version")
    return diff.max().item()


def _lrn_case(torch, lrn, gen, shape, size):
    x = torch.randn(*shape, generator=gen, device="cuda")
    # tests/test_kernels_misc.py:35: rtol 1e-5, atol 1e-6
    return _close_case(torch, f"lrn f32 {shape} size {size}", lrn.lrn_cuda(x, size=size),
                       lrn.lrn_plain(x, size=size), 1e-5, 1e-6)


def _avgpool_case(torch, avgpool, gen, shape, ks, offset=0):
    numel = shape[0] * shape[1] * shape[2] * shape[3]
    x = torch.randn(numel + offset, generator=gen, device="cuda")[offset:].view(shape)
    what = f"avgpool f32 {shape} k {ks}" + (f" at a {offset}-float offset" if offset else "")
    # tests/test_kernels_misc.py:43: 1e-6
    return _close_case(torch, what, avgpool.avgpool_cuda(x, ksize=ks),
                       avgpool.avgpool_plain(x, ksize=ks), 1e-6, 1e-6)


def phase_kernels(torch) -> dict:
    from repro_torch.kernels import avgpool, lrn, matmul, softmax

    print("== phase 3: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {name: 0.0 for name in KERNEL_SOURCES}
    for dt in (torch.float32, torch.bfloat16):
        key = f"matmul_{'f32' if dt == torch.float32 else 'bf16'}"
        for m, k, n in SMALL_SHAPES:
            for trans in ("nn", "tn"):
                _matmul_case(torch, matmul, gen, dt, m, k, n, trans)
        for trans in ("nn", "tn"):
            e = _matmul_case(torch, matmul, gen, dt, GEMM_N, GEMM_N, GEMM_N, trans)
            err[key] = max(err[key], e)
    err["matmul_f32"] = max(
        err["matmul_f32"],
        _matmul_case(torch, matmul, gen, torch.float32, *CONNECTED_PRESET4, "nn"),
    )
    for dt in (torch.float32, torch.bfloat16):
        for shared in (True, False):
            for m, k, n in ((8, 8, 8), (130, 70, 50), (1, 256, 33)):
                _batched_matmul_case(torch, matmul, gen, dt, 3, m, k, n, shared)
    images, o, ckk, ohw = CONV_PRESET4
    err["matmul_f32_batched"] = _batched_matmul_case(
        torch, matmul, gen, torch.float32, images, o, ckk, ohw, True
    )
    for dt in (torch.float32, torch.bfloat16):
        for r, c in SOFTMAX_SMALL:
            _softmax_case(torch, softmax, gen, dt, r, c)
            _softmax_case(torch, softmax, gen, dt, r, c, scale=1.0)
        e = _softmax_case(torch, softmax, gen, dt, *SOFTMAX_PRESET4)
        if dt == torch.float32:
            err["softmax_f32"] = e
            _softmax_case(torch, softmax, gen, dt, *SOFTMAX_PRESET4, scale=1.0)
    for shape, size in LRN_CASES:
        _lrn_case(torch, lrn, gen, shape, size)
    err["lrn_f32"] = _lrn_case(torch, lrn, gen, LRN_PRESET4, 5)
    for shape, ks in AVGPOOL_CASES:
        _avgpool_case(torch, avgpool, gen, shape, ks)
    _avgpool_case(torch, avgpool, gen, (2, 3, 8, 8), 2, offset=1)  # no float2 path
    err["avgpool_f32"] = _avgpool_case(torch, avgpool, gen, AVGPOOL_PRESET4, 2)
    return err


def _expected_launches() -> dict:
    from repro_torch.core.registry import get_benchmark

    per_call = {}
    for name in MAIN_PATH:
        size = get_benchmark(name).presets[PRESET]
        if name == "softmax":
            per_call[name] = ("softmax_f32", 1)
        elif name == "connected":
            per_call[name] = ("matmul_f32", 1)
        else:
            kernel = f"matmul_{size['dtype']}"
            per_call[name] = (kernel, size.get("chain", 1))
    want = {k: 0 for k in _read_launches()}
    for kernel, n in per_call.values():
        want[kernel] += n * CALLS_PER_PASS
    return want


def _run_suite(torch, names, label, backward):
    """One suite run at preset 4 with ``--impl kernel``, launch counters set
    to 0 just before and read just after. -> (launches, records, wall s)."""
    from repro_torch.core import suite
    from repro_torch.core.results import load_run

    _zero_launches()
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, f"{label}.jsonl")
        t0 = time.perf_counter()
        rc = suite.main([
            "--names", *names, "--preset", str(PRESET), "--impl", "kernel",
            *(() if backward else ("--no-backward",)), "--iters", str(ITERS),
            "--warmup", str(WARMUP), "--timing-window", str(WINDOW), "--jsonl", jsonl,
        ])
        wall = time.perf_counter() - t0
        launches = _read_launches()
        meta, records = load_run(jsonl)
    print(f"suite exit {rc} in {wall:.1f} s; launches {launches}")
    if rc != 0:
        _fail(f"the suite exited {rc} on the {label}")
    if (meta is None or meta.backend != "cuda" or meta.allow_tf32_matmul
            or meta.allow_tf32_cudnn):
        _fail(f"run metadata does not say cuda without TF32: {meta}")
    return launches, records, wall


def _print_row(torch, rec, wl, backward, hw, bytes_only=False):
    from repro_torch.core.metrics import roofline_terms

    dt = torch.bfloat16 if "bf16" in rec.name else torch.float32
    flops = wl.flops_bwd if backward else wl.flops
    roof = roofline_terms(0.0 if bytes_only else flops, wl.bytes_moved, dtype=dt, hw=hw)
    by = "bytes alone" if bytes_only else roof.dominant
    impl = rec.impl + (f"/{rec.impl_fallback}" if rec.impl_fallback else "")
    print(f"  {rec.name:38s} impl {impl} us_per_call {rec.us_per_call:.1f} us_per_call_windowed "
          f"{rec.us_per_call_windowed:.1f} GFLOP/s {rec.achieved_gflops:.1f} "
          f"GB/s {rec.achieved_gbps:.1f} bound_us {roof.bound_s * 1e6:.1f} ({by}) "
          f"roofline_fraction {roof.bound_s * 1e6 / rec.us_per_call_windowed:.3f} "
          f"build_s {rec.stage_timings_us['build'] / 1e6:.2f}")


def phase_main_path(torch) -> dict:
    from repro_torch.core.metrics import peaks_for
    from repro_torch.core.registry import get_benchmark

    print("== phase 4: main path (suite, preset 4, --impl kernel, forward)")
    launches, records, _ = _run_suite(torch, MAIN_PATH, "main path", backward=False)
    if len(records) != len(MAIN_PATH):
        _fail(f"{len(records)} records, expected {len(MAIN_PATH)}")
    hw = peaks_for(torch.cuda.get_device_name(0))
    for rec in records:
        if rec.status != "ok" or rec.impl != "kernel" or rec.impl_interpret is not False:
            _fail(f"row {rec.name}: status={rec.status} impl={rec.impl} "
                  f"interpret={rec.impl_interpret} {rec.error}")
    for name, rec in zip(sorted(MAIN_PATH, key=_order), records, strict=True):
        _print_row(torch, rec, get_benchmark(name).build_preset(PRESET), False, hw)
    want = _expected_launches()
    if launches != want:
        _fail(f"launch counts {launches} differ from the expected {want}")
    for kernel in ("matmul_f32", "matmul_bf16", "softmax_f32"):
        if want[kernel] == 0:
            _fail(f"kernel {kernel} of the main path did not launch")
    return launches


def phase_dnn(torch) -> dict:
    from repro_torch.core.metrics import peaks_for
    from repro_torch.core.registry import get_benchmark

    print("== phase 4a: DNN section (suite, preset 4, --impl kernel, forward and backward)")
    launches, records, _ = _run_suite(torch, DNN_PATH, "DNN section", backward=True)
    if len(records) != 2 * len(DNN_PATH):
        _fail(f"{len(records)} records, expected {2 * len(DNN_PATH)}")
    hw = peaks_for(torch.cuda.get_device_name(0))
    workloads = {}
    for name in DNN_PATH:
        wl = get_benchmark(name).build_preset(PRESET)
        workloads[wl.name] = (name, wl)
    for rec in records:
        backward = rec.name.endswith(".bwd")
        name, wl = workloads[rec.name.removesuffix(".bwd")]
        if name not in DNN_KERNELS:
            want = ("torch", "no_kernel", None)
        elif backward:
            want = ("torch", "backward_pass", None)
        else:
            want = ("kernel", None, False)
        got = (rec.impl, rec.impl_fallback, rec.impl_interpret)
        if rec.status != "ok" or got != want:
            _fail(f"row {rec.name}: status={rec.status} (impl, fallback, interpret) = "
                  f"{got}, expected {want}: {rec.error}")
        # LRN's flops count the reference's TPU band matmul (2*C per element,
        # 17.3 GFLOP at preset 4), not what the kernel does (about 2*size+4
        # per element): its bound is taken from the bytes it must move.
        _print_row(torch, rec, wl, backward, hw, bytes_only=(name == "lrn"))
    want = {k: 0 for k in launches}
    for kernel in DNN_KERNELS.values():
        want[kernel] = CALLS_PER_PASS  # forward only: backward passes run torch
    if launches != want:
        _fail(f"launch counts {launches} differ from the expected {want}")
    return launches


def _order(name: str):
    from repro_torch.core.registry import get_benchmark

    spec = get_benchmark(name)
    return (spec.level, spec.name)


def _f64_math(name: str, args):
    """(exact output, A, B, chain) of an f32 GEMM row: its math in f64."""
    d = [a.double() for a in args]
    if name == "gemm_f32_nn":
        return d[0] @ d[1], d[0], d[1], 1
    if name == "gemm_f32_tn":
        return d[0].T @ d[1], d[0].T, d[1], 1
    if name == "connected":
        x, w, bias = d
        return x @ w + bias, x, w, 1
    if name == "maxflops_f32":
        from repro_torch.core.registry import get_benchmark

        chain = get_benchmark(name).presets[0]["chain"]
        acc = d[0]
        for _ in range(chain):
            acc = acc @ d[1]
        return acc, d[0], d[1], chain
    raise KeyError(name)


def phase_small_agreement(torch) -> None:
    from repro_torch.core.engine import bind_impl
    from repro_torch.core.harness import commit_args
    from repro_torch.core.registry import get_benchmark

    print("== phase 4b: kernel rows at preset 0, kernel against torch")
    for name in MAIN_PATH + tuple(DNN_KERNELS):
        wl = get_benchmark(name).build_preset(0)
        args = commit_args(wl.make_inputs(0), "cuda")
        out_k = bind_impl(wl.fn, wl, "kernel")(*args).float()
        out_t = bind_impl(wl.fn, wl, "torch")(*args).float()
        torch.cuda.synchronize()
        if name == "softmax":
            close, _, max_rel = _softmax_agrees(out_k, out_t, args[0].dtype)
            why = f"max_rel {max_rel:.3e} rtol {REF_TOL[_dtname(args[0].dtype)]:g} atol 1e-30"
        elif name in ("gemm_f32_nn", "gemm_f32_tn", "connected", "maxflops_f32"):
            # Order-insensitive: both held against the same math in f64, with
            # the K-scaled bound of phase 3 (a 256-term f32 sum in another
            # order than cuBLAS's differs from it by more than 1e-5).
            exact, a, b, chain = _f64_math(name, args)
            close, why, _ = _exact_check(out_k, out_t, exact, a.shape[1],
                                         _rms(a) * _rms(b), torch.float32, chain)
        else:
            # bf16 rows: the reference's 2e-2; convolution: its validate's
            # 2e-4; LRN and avgpool: the reference's kernel tests' tolerances.
            rtol, atol = {"convolution_im2col": (2e-4, 2e-4), "lrn": (1e-5, 1e-6),
                          "pooling": (1e-6, 1e-6)}.get(name, (2e-2, 2e-2))
            close = torch.allclose(out_k, out_t, rtol=rtol, atol=atol)
            why = f"rtol {rtol:g} atol {atol:g}"
        ok = out_k.shape == out_t.shape and bool(torch.isfinite(out_k).all()) and close
        print(f"  {name:18s} shape {tuple(out_k.shape)} max_abs "
              f"{(out_k - out_t).abs().max().item():.3e} {why} {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"{name} at preset 0: kernel and torch disagree")


def _time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _yardstick_cases(torch, gen, hw):
    """(key, shape, roofline, (kernel, plain, library)) at the paths' shapes."""
    import torch.nn.functional as F

    from repro_torch.core.metrics import roofline_terms
    from repro_torch.kernels import avgpool, lrn, matmul, softmax

    rows = []
    for dt, key in ((torch.float32, "matmul_f32"), (torch.bfloat16, "matmul_bf16")):
        n = GEMM_N
        a = torch.randn(n, n, generator=gen, device="cuda").to(dt)
        b = torch.randn(n, n, generator=gen, device="cuda").to(dt)
        cases = (
            functools.partial(matmul.matmul_cuda, a, b),
            functools.partial(matmul.matmul_plain, a, b),
            functools.partial(torch.matmul, a, b),
        )
        roof = roofline_terms(2.0 * n**3, 3.0 * n * n * dt.itemsize, dtype=dt, hw=hw)
        rows.append((key, f"{n}x{n}x{n}", roof, cases))
    r, c = SOFTMAX_PRESET4
    x = 5 * torch.randn(r, c, generator=gen, device="cuda")
    cases = (
        functools.partial(softmax.softmax_cuda, x),
        functools.partial(softmax.softmax_plain, x),
        functools.partial(torch.softmax, x, dim=-1),
    )
    roof = roofline_terms(5.0 * r * c, 8.0 * r * c, dtype=torch.float32, hw=hw)
    rows.append(("softmax_f32", f"{r}x{c}", roof, cases))
    # Convolution's im2col product at preset 4: a shared weight matrix times
    # every image's patch matrix; each input read once, the output written
    # once.
    images, o, ckk, ohw = CONV_PRESET4
    wmat = torch.randn(o, ckk, generator=gen, device="cuda") * ckk**-0.5
    cols = torch.randn(images, ckk, ohw, generator=gen, device="cuda")
    cases = (
        functools.partial(matmul.matmul_cuda, wmat, cols),
        functools.partial(matmul.matmul_plain, wmat, cols),
        functools.partial(torch.matmul, wmat, cols),
    )
    roof = roofline_terms(2.0 * images * o * ckk * ohw,
                          4.0 * (o * ckk + images * ckk * ohw + images * o * ohw),
                          dtype=torch.float32, hw=hw)
    rows.append(("matmul_f32_batched", f"{images}x({o}x{ckk}x{ohw})", roof, cases))
    # LRN at preset 4, size 5: 8 bytes per element; about 2*size+4
    # operations per element (size squares and adds, alpha, k, pow, divide).
    size = 5
    x = torch.randn(*LRN_PRESET4, generator=gen, device="cuda")
    numel = x.numel()
    # torch's LRN divides alpha by size (an average over the window).
    library = functools.partial(F.local_response_norm, x, size, alpha=size * 1e-4,
                                beta=0.75, k=2.0)
    _close_case(torch, "torch.nn.functional.local_response_norm (alpha*size) vs plain",
                library(), lrn.lrn_plain(x, size=size), 1e-5, 1e-6)
    cases = (functools.partial(lrn.lrn_cuda, x, size=size),
             functools.partial(lrn.lrn_plain, x, size=size), library)
    roof = roofline_terms((2 * size + 4) * numel, 8.0 * numel, dtype=torch.float32, hw=hw)
    rows.append(("lrn_f32", "x".join(map(str, LRN_PRESET4)), roof, cases))
    # Average pool at preset 4, k=2: each input read once, a quarter as many
    # outputs written; one add per input.
    x = torch.randn(*AVGPOOL_PRESET4, generator=gen, device="cuda")
    numel = x.numel()
    library = functools.partial(F.avg_pool2d, x, 2)
    _close_case(torch, "torch.nn.functional.avg_pool2d vs plain", library(),
                avgpool.avgpool_plain(x, ksize=2), 1e-6, 1e-6)
    cases = (functools.partial(avgpool.avgpool_cuda, x, ksize=2),
             functools.partial(avgpool.avgpool_plain, x, ksize=2), library)
    roof = roofline_terms(numel, 4.0 * numel * (1 + 1 / 4), dtype=torch.float32, hw=hw)
    rows.append(("avgpool_f32", "x".join(map(str, AVGPOOL_PRESET4)) + " k2", roof, cases))
    return rows


def phase_yardstick(torch, launches: dict, errors: dict) -> list:
    from repro_torch.core.metrics import peaks_for

    print("== phase 5: yardstick at the paths' shapes (CUDA events)")
    hw = peaks_for(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []
    for key, shape, roof, (kernel, plain, library) in _yardstick_cases(torch, gen, hw):
        # plain, kernel, library, kernel, plain: each side timed twice, in turns
        p1, k1, lib, k2, p2 = (_time_ms(torch, f) for f in (plain, kernel, library, kernel, plain))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        src, replaces = KERNEL_SOURCES[key]
        entry = {
            "name": key, "route": "cuda", "source": src, "replaces": replaces,
            "shape": shape, "launches": launches[key], "max_abs_err": errors[key],
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": roof.bound_s * 1e3,
            "bound_by": "operations" if roof.compute_s >= roof.memory_s else "bytes",
            "library_ms": lib,
        }
        print(f"  {key:18s} {shape:24s} kernel {ms:.4f} ms (runs {k1:.4f}, {k2:.4f}) "
              f"plain {plain_ms:.4f} ms library {lib:.4f} ms bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']}) = {entry['bound_ms'] / ms:.3f} of bound")
        out.append(entry)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a "
              "CUDA card", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails without the repository's src/)

    t0 = time.perf_counter()
    smi = phase_card(torch)
    phase_build()
    errors = phase_kernels(torch)
    main_launches = phase_main_path(torch)
    dnn_launches = phase_dnn(torch)
    phase_small_agreement(torch)
    # Each kernel launched on one path only (both counts were checked), so
    # the sum is each kernel's count on its path.
    launches = {k: main_launches[k] + dnn_launches[k] for k in main_launches}
    kernels = phase_yardstick(torch, launches, errors)
    if sorted(k["name"] for k in kernels) != sorted(KERNEL_SOURCES):
        _fail("the kernels line does not list every kernel of the paths")
    leaked = sorted(
        m for m in sys.modules
        if m in ("jax", "repro") or m.startswith(("jax.", "jaxlib", "repro."))
    )
    if leaked:
        _fail(f"the port pulled in JAX or the JAX package: {leaked[:5]}")
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
