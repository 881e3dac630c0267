"""Per-launch device profile of the f32 GEMM, the radix sort, the row
softmax, the LRN, the SRAD step and attention at the paths' shapes: which
CUDA kernels one call launches, how many of each, and the device time of
each, summed per kernel name over the call.

    python -m repro_torch.launch.profile_kernels [--calls 10] [--match TEXT] [--json PATH]

Cases (all on the card, inputs from a seeded CUDA generator):

- ``matmul_cuda`` at 4096^3 f32, ``nn`` and ``tn`` (``a.T``, as the gemm
  "tn" specs pass it): the GEMM and MaxFlops f32 rows;
- ``matmul_cuda`` at Connected's (1024 x 4096) . (4096 x 4096);
- ``matmul_cuda`` of a shared (256, 2304) weight times (64, 2304, 900)
  patch matrices: Convolution's im2col product;
- ``sort_kv_cuda`` of 2^24 int32 keys in [0, 2^30) with int32 values: the
  Sort row;
- ``softmax_cuda`` of 32768 x 16384 f32 logits, 5 * N(0, 1): the Softmax
  row at preset 4;
- ``lrn_cuda`` of a (128, 512, 16, 16) f32 N(0, 1) input, size 5: the LRN
  row at preset 4;
- ``srad_step_cuda`` of a 1024 x 1024 f32 exp(0.1 N(0, 1)) image, fused
  and split: one step of the SRAD rows at preset 4; and the same step on
  the replaced entries, ``srad_fused_f32_gridstride`` and
  ``srad_phase1_f32_scalar``;
- ``flash_attention_cuda`` of a bf16 decode step of granite-3-8b at batch
  8 (B8 Hq32 Hkv8, T=1 against S=1088, D128): the serving path's decode
  layer, one launch;
- ``flash_attention_f32`` in f32 at the f32 smoke LM's own shapes (B4 Hq4
  Hkv2 D16: the causal prefill T=S=16 and a decode step T=1, S=32) and at
  full width (B8 Hq32 Hkv8 T=S=1024 D128, causal), and the SIMT kernel it
  replaced (``flash_attention_f32_simt``) at the same shapes.

``--match`` keeps the cases whose name holds the text (all by default).

Each case is called once to build and warm up, then once more traced but
not recorded, then ``--calls`` times recorded by ``torch.profiler``
(CUPTI), each call synchronised. A line per kernel name: launches per
call and device ms per call. The card's name and power limit lead the
output, as ``nvidia-smi`` prints them. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["main"]


def _cases(torch, gen):
    from repro_torch.kernels import bitonic_sort, lrn, matmul, softmax
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import srad_stencil as srad

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    n = 4096
    a, b = randn(n, n), randn(n, n)
    at = randn(n, n).T
    x, w = randn(1024, n), randn(n, n)
    wmat, cols = randn(256, 2304), randn(64, 2304, 900)
    keys = torch.randint(0, 1 << 30, (1 << 24,), generator=gen, device="cuda",
                         dtype=torch.int32)
    vals = torch.arange(1 << 24, dtype=torch.int32, device="cuda")
    logits = 5 * randn(32768, 16384)
    maps = randn(128, 512, 16, 16)
    img = torch.exp(0.1 * randn(1024, 1024))

    def qkv(dtype, b, hq, hkv, t, s, d):
        return (randn(b, hq, t, d).to(dtype), randn(b, hkv, s, d).to(dtype),
                randn(b, hkv, s, d).to(dtype))

    step = qkv(torch.bfloat16, 8, 32, 8, 1, 1088, 128)
    f32_cases = []
    for what, shape, causal in (("smoke prefill B4 Hq4 Hkv2 T=S=16 D16 causal",
                                 (4, 4, 2, 16, 16, 16), True),
                                ("smoke decode B4 Hq4 Hkv2 T=1 S=32 D16", (4, 4, 2, 1, 32, 16),
                                 False),
                                ("prefill B8 Hq32 Hkv8 T=S=1024 D128 causal",
                                 (8, 32, 8, 1024, 1024, 128), True)):
        ops = qkv(torch.float32, *shape)
        for entry in ("flash_attention_f32", "flash_attention_f32_simt"):
            f32_cases.append((f"attention f32 {what} on {entry}",
                              lambda e=entry, x=ops, c=causal: fa._launch(e, *x, causal=c)))
    return (
        ("matmul_cuda f32 4096^3 nn", lambda: matmul.matmul_cuda(a, b)),
        ("matmul_cuda f32 4096^3 tn", lambda: matmul.matmul_cuda(at, b)),
        ("matmul_cuda f32 (1024x4096).(4096x4096)", lambda: matmul.matmul_cuda(x, w)),
        ("matmul_cuda f32 64x(256x2304 . 2304x900) shared A",
         lambda: matmul.matmul_cuda(wmat, cols)),
        ("sort_kv_cuda 2^24 int32 keys [0, 2^30)",
         lambda: bitonic_sort.sort_kv_cuda(keys, vals)),
        ("softmax_cuda f32 32768x16384 5*randn", lambda: softmax.softmax_cuda(logits)),
        ("lrn_cuda f32 (128, 512, 16, 16) size 5", lambda: lrn.lrn_cuda(maps, size=5)),
        ("srad_cuda f32 1024^2 fused step", lambda: srad.srad_step_cuda(img)),
        ("srad_cuda f32 1024^2 split step", lambda: srad.srad_step_cuda(img, fused=False)),
        ("srad_cuda f32 1024^2 fused step on srad_fused_f32_gridstride",
         lambda: srad._launch("srad_fused_f32_gridstride", img)),
        ("srad_cuda f32 1024^2 phase 1 on srad_phase1_f32_scalar",
         lambda: srad._launch("srad_phase1_f32_scalar", img)),
        ("attention bf16 decode B8 Hq32 Hkv8 T=1 S=1088 D128 (one launch)",
         lambda: fa.flash_attention_cuda(*step)),
        *f32_cases,
    )


def _profile(torch, fn, calls: int) -> list[dict]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # One traced warm-up step before the recorded ones, so the tracer is
    # running before the first recorded launch.
    ready = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls),
                 on_trace_ready=lambda p: ready.append(p.key_averages())) as prof:
        for _ in range(calls + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    rows = []
    for e in ready[0] if ready else ():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        rows.append({"kernel": e.key, "launches_per_call": e.count / calls,
                     "device_ms_per_call": us / 1e3 / calls})
    if not rows:
        raise RuntimeError("torch.profiler recorded no device activity")
    return sorted(rows, key=lambda r: -r["device_ms_per_call"])


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--calls", type=int, default=10)
    p.add_argument("--match", default="", help="only the cases whose name holds this text")
    p.add_argument("--json", help="also write the profile to this file")
    args = p.parse_args(argv)

    import torch

    from repro_torch.core.results import gpu_name_and_power_limit

    if not torch.cuda.is_available():
        print("profile_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    print(gpu_name_and_power_limit())
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for what, fn in _cases(torch, gen):
        if args.match not in what:
            continue
        rows = _profile(torch, fn, args.calls)
        out[what] = rows
        total = sum(r["device_ms_per_call"] for r in rows)
        print(f"{what}: device {total:.4f} ms per call")
        for r in rows:
            print(f"  {r['device_ms_per_call']:9.4f} ms  x{r['launches_per_call']:g}  "
                  f"{r['kernel'][:110]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
