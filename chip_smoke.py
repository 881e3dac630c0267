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
   test shapes and at the main path's shapes, with the stated tolerances;
4. the main path: the port's suite at preset 4 with ``--impl kernel`` over
   the 8 benchmarks of this slice, with every launch counter set to 0 just
   before and read just after (each kernel must have launched, exactly as
   often as the engine's stages call it); then the same benchmarks at
   preset 0, kernel against torch on the same inputs;
5. yardstick: each kernel of the path, its plain version and the one
   PyTorch call that computes the same function, timed with CUDA events at
   the main path's shapes, beside the card's bound for the same work.

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
PRESET, ITERS, WARMUP, WINDOW = 4, 5, 2, 4
# Calls of each pass's function on the main path: the compile stage's first
# call, the validation call, the sync-mode warm-up and timed calls, and the
# windowed calls.
CALLS_PER_PASS = 1 + 1 + WARMUP + ITERS + ITERS * WINDOW
U_F32 = 2.0**-24  # unit round-off of f32
SMALL_SHAPES = [(8, 8, 8), (128, 128, 128), (130, 70, 50), (1, 256, 33), (257, 1, 128)]
SOFTMAX_SMALL = [(1, 8), (33, 257), (64, 64), (7, 1031)]
REF_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_kernels_*.py
KERNEL_SOURCES = {
    "matmul_f32": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:55"),
    "matmul_bf16": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:55"),
    "softmax_f32": ("src/repro_torch/kernels/csrc/softmax.cu", "src/repro/kernels/softmax.py:68"),
}


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _dtname(dt) -> str:
    return str(dt).replace("torch.", "")


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
        # Held first against the exact product: f64 holds every product of
        # two f32 or bf16 inputs exactly and sums K=4096 of them far below
        # f32's round-off. The kernel adds the K products one after another
        # in f32; each rounding errs by at most u times the running sum,
        # whose rms after k terms is sqrt(k)*sigma (sigma = rms(A)*rms(B)),
        # so the error's rms is about u*sigma*K/sqrt(12). Outputs far from
        # zero carry larger running sums and larger errors: on an H100 the
        # largest of 16M outputs came to 4.7*u*sigma*K (1.15e-3 at unit
        # inputs), for cuBLAS's f32 product too. ATOL = 16*u*K*sigma
        # (3.9e-3) leaves 3.4x on that, while a kernel that rounded its
        # inputs to TF32 (2^-11) or bf16 errs by about sqrt(K)*2^-11*sigma*
        # 0.8 ~ 0.026 on a typical output (0.25 at most) and fails. A bf16
        # output adds its own rounding, 2^-8 of the value.
        exact = torch.matmul(a.double(), b.double())
        sigma = (a.double().square().mean().sqrt() * b.double().square().mean().sqrt()).item()
        atol = 16 * k * U_F32 * sigma
        rtol = 0.0 if dt == torch.float32 else 2.0**-8
        err = (out.double() - exact).abs()
        plain_err = (plain.double() - exact).abs()
        ok_exact = bool((err <= atol + rtol * exact.abs()).all())
        ok_plain_exact = bool((plain_err <= atol + rtol * exact.abs()).all())
        # Both within ATOL (+ rounding) of the exact product, so within
        # twice that of each other; two bf16 roundings differ by at most one
        # bf16 ulp, 2^-7 of the value.
        ok_plain = bool((diff <= 2 * atol + 2 * rtol * plain.abs()).all())
        ok = ok_exact and ok_plain_exact and ok_plain
        print(f"  matmul {_dtname(dt):8s} {trans} ({m},{k},{n}) vs f64: kernel max_abs "
              f"{err.max().item():.3e}, plain max_abs {plain_err.max().item():.3e} "
              f"[16*K*u*sigma = {atol:.3e}, rtol {rtol:g}]; vs plain max_abs "
              f"{diff.max().item():.3e} [2x that] {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"matmul {dt} {trans} {(m, k, n)} disagrees with its plain version")
    return diff.max().item()


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


def phase_kernels(torch) -> dict:
    from repro_torch.kernels import matmul, softmax

    print("== phase 3: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {name: 0.0 for name in KERNEL_SOURCES}
    for dt in (torch.float32, torch.bfloat16):
        key = f"matmul_{'f32' if dt == torch.float32 else 'bf16'}"
        for m, k, n in SMALL_SHAPES:
            for trans in ("nn", "tn"):
                _matmul_case(torch, matmul, gen, dt, m, k, n, trans)
        for trans in ("nn", "tn"):
            e = _matmul_case(torch, matmul, gen, dt, 4096, 4096, 4096, trans)
            err[key] = max(err[key], e)
    # connected at preset 4: (1024, 4096) @ (4096, 4096), f32
    err["matmul_f32"] = max(
        err["matmul_f32"],
        _matmul_case(torch, matmul, gen, torch.float32, 1024, 4096, 4096, "nn"),
    )
    for dt in (torch.float32, torch.bfloat16):
        for r, c in SOFTMAX_SMALL:
            _softmax_case(torch, softmax, gen, dt, r, c)
            _softmax_case(torch, softmax, gen, dt, r, c, scale=1.0)
        e = _softmax_case(torch, softmax, gen, dt, 32768, 16384)
        if dt == torch.float32:
            err["softmax_f32"] = e
            _softmax_case(torch, softmax, gen, dt, 32768, 16384, scale=1.0)
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
    want = {k: 0 for k in KERNEL_SOURCES}
    for kernel, n in per_call.values():
        want[kernel] += n * CALLS_PER_PASS
    return want


def phase_main_path(torch) -> dict:
    from repro_torch.core import suite
    from repro_torch.core.registry import get_benchmark
    from repro_torch.core.results import load_run
    from repro_torch.core.metrics import peaks_for, roofline_terms
    from repro_torch.kernels import matmul, softmax

    print("== phase 4: main path (suite, preset 4, --impl kernel)")
    for mod in (matmul, softmax):
        for key in mod.launches:
            mod.launches[key] = 0
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "main_path.jsonl")
        t0 = time.perf_counter()
        rc = suite.main([
            "--names", *MAIN_PATH, "--preset", str(PRESET), "--impl", "kernel",
            "--no-backward", "--iters", str(ITERS), "--warmup", str(WARMUP),
            "--timing-window", str(WINDOW), "--jsonl", jsonl,
        ])
        wall = time.perf_counter() - t0
        launches = {**matmul.launches, **softmax.launches}
        meta, records = load_run(jsonl)
    print(f"suite exit {rc} in {wall:.1f} s; launches {launches}")
    if rc != 0:
        _fail(f"the suite exited {rc}")
    if meta is None or meta.backend != "cuda" or meta.allow_tf32_matmul:
        _fail(f"run metadata does not say cuda without TF32: {meta}")
    if len(records) != len(MAIN_PATH):
        _fail(f"{len(records)} records, expected {len(MAIN_PATH)}")
    hw = peaks_for(torch.cuda.get_device_name(0))
    for rec in records:
        if rec.status != "ok" or rec.impl != "kernel" or rec.impl_interpret is not False:
            _fail(f"row {rec.name}: status={rec.status} impl={rec.impl} "
                  f"interpret={rec.impl_interpret} {rec.error}")
    for name, rec in zip(sorted(MAIN_PATH, key=_order), records, strict=True):
        wl = get_benchmark(name).build_preset(PRESET)
        dt = torch.bfloat16 if "bf16" in name else torch.float32
        roof = roofline_terms(wl.flops, wl.bytes_moved, dtype=dt, hw=hw)
        print(f"  {rec.name:24s} us_per_call {rec.us_per_call:.1f} "
              f"us_per_call_windowed {rec.us_per_call_windowed:.1f} "
              f"GFLOP/s {rec.achieved_gflops:.1f} GB/s {rec.achieved_gbps:.1f} "
              f"bound_us {roof.bound_s * 1e6:.1f} ({roof.dominant}) "
              f"roofline_fraction {roof.bound_s * 1e6 / rec.us_per_call_windowed:.3f}")
    want = _expected_launches()
    if launches != {**want, "softmax_bf16": 0}:
        _fail(f"launch counts {launches} differ from the expected {want}")
    for kernel, n in want.items():
        if n == 0:
            _fail(f"kernel {kernel} of the main path did not launch")
    return launches


def _order(name: str):
    from repro_torch.core.registry import get_benchmark

    spec = get_benchmark(name)
    return (spec.level, spec.name)


def phase_small_agreement(torch) -> None:
    from repro_torch.core.engine import bind_impl
    from repro_torch.core.harness import commit_args
    from repro_torch.core.registry import get_benchmark

    print("== phase 4b: main path at preset 0, kernel against torch")
    for name in MAIN_PATH:
        wl = get_benchmark(name).build_preset(0)
        args = commit_args(wl.make_inputs(0), "cuda")
        out_k = bind_impl(wl.fn, wl, "kernel")(*args).float()
        out_t = bind_impl(wl.fn, wl, "torch")(*args).float()
        if name == "softmax":
            close, _, max_rel = _softmax_agrees(out_k, out_t, args[0].dtype)
            why = f"max_rel {max_rel:.3e} rtol {REF_TOL[_dtname(args[0].dtype)]:g} atol 1e-30"
        else:
            # f32 rows sum 256 products per output in another order than the
            # plain version: 1e-4 holds them (the Higham bound
            # 2*K*u*max(|A||B|) is about 6e-3 here); bf16 rows keep the
            # reference's 2e-2.
            tol = 2e-2 if "bf16" in name else 1e-4
            close = torch.allclose(out_k, out_t, rtol=tol, atol=tol)
            why = f"tol {tol:g}"
        ok = out_k.shape == out_t.shape and bool(torch.isfinite(out_k).all()) and close
        print(f"  {name:14s} shape {tuple(out_k.shape)} max_abs "
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


def phase_yardstick(torch, launches: dict, errors: dict) -> list:
    from repro_torch.core.metrics import peaks_for, roofline_terms
    from repro_torch.kernels import matmul, softmax

    print("== phase 5: yardstick at the main path's shapes (CUDA events)")
    hw = peaks_for(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for dt, key in ((torch.float32, "matmul_f32"), (torch.bfloat16, "matmul_bf16")):
        n = 4096
        a = torch.randn(n, n, generator=gen, device="cuda").to(dt)
        b = torch.randn(n, n, generator=gen, device="cuda").to(dt)
        cases = (
            functools.partial(matmul.matmul_cuda, a, b),
            functools.partial(matmul.matmul_plain, a, b),
            functools.partial(torch.matmul, a, b),
        )
        roof = roofline_terms(2.0 * n**3, 3.0 * n * n * dt.itemsize, dtype=dt, hw=hw)
        rows.append((key, f"{n}x{n}x{n}", roof, cases))
    r, c = 32768, 16384
    x = 5 * torch.randn(r, c, generator=gen, device="cuda")
    cases = (
        functools.partial(softmax.softmax_cuda, x),
        functools.partial(softmax.softmax_plain, x),
        functools.partial(torch.softmax, x, dim=-1),
    )
    roof = roofline_terms(5.0 * r * c, 8.0 * r * c, dtype=torch.float32, hw=hw)
    rows.append(("softmax_f32", f"{r}x{c}", roof, cases))
    out = []
    for key, shape, roof, (kernel, plain, library) in rows:
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
        print(f"  {key:12s} {shape:16s} kernel {ms:.4f} ms (runs {k1:.4f}, {k2:.4f}) "
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
    launches = phase_main_path(torch)
    phase_small_agreement(torch)
    kernels = phase_yardstick(torch, launches, errors)
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
