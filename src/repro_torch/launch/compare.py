"""Serve one model from two checkouts of this repository on one card, in
turns, and print what each run measured: the serving path's end-to-end
numbers for an A/B of two commits under the same load on the same card.

    python -m repro_torch.launch.compare --a build/parent --b . \\
        --arch granite-3-8b --requests 16 --batch 8 --prompt-len 1024 --gen-len 64

The runs go A, B, B, A, each in its own process that imports
``repro_torch`` from ``<tree>/src`` (so each tree builds and launches its
own kernels), builds the published config at full width with random
weights from seed 0, serves one warm-up round, then the load: CUDA events
around every ``prefill`` and ``decode_step`` call, the host's wall clock
around the whole ``serve``. One JSON line per run: tokens/s, prefill ms
per call, decode-step ms (mean, min, max over the steps), and the card's
name and power limit. A child uses only what both trees export
(``Model``, ``get_config``, ``serve``). It needs a CUDA card.

With ``--attention`` the runs time ``flash_attention_cuda`` instead (and,
for one shape, ``flash_decode_partials_cuda``: the attention entries both
trees export), on each shape of ``ATTENTION_SHAPES`` whose name holds
``--match``, with inputs from seed 0: CUDA events over 200 back-to-back
calls (host time included), the device's time per call from
``torch.profiler`` (0 when it dropped its records), and 50 calls captured
back to back in one CUDA graph, replayed (the device's pace with no host
time, gaps between a call's kernels included). One JSON line per run and
shape.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

__all__ = ["main"]

_CHILD = r"""
import json, subprocess, sys
tree, arch, requests, batch, prompt_len, gen_len = sys.argv[1:7]
sys.path.insert(0, tree + "/src")
import torch
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.models import Model

requests, batch, prompt_len, gen_len = map(int, (requests, batch, prompt_len, gen_len))
max_len = prompt_len + gen_len + 8
cfg = get_config(arch)
model = Model(cfg, device="cuda")
model.init_weights(torch.Generator(device="cuda").manual_seed(0))
serve(arch=arch, smoke=False, device="cuda", model=model, n_requests=batch, batch=batch,
      prompt_len=prompt_len, gen_len=4, max_len=max_len)
events = {"prefill": [], "decode_step": []}
for kind in events:
    fn = getattr(model, kind)
    def call(*args, fn=fn, kind=kind):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        events[kind].append((start, end))
        return out
    setattr(model, kind, call)
stats = serve(arch=arch, smoke=False, device="cuda", model=model, n_requests=requests,
              batch=batch, prompt_len=prompt_len, gen_len=gen_len, max_len=max_len)
torch.cuda.synchronize()
ms = {k: [s.elapsed_time(e) for s, e in v] for k, v in events.items()}
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip().splitlines()
print(json.dumps({
    "tree": tree, "tokens_per_s": stats.tokens_per_s, "wall_s": stats.wall_s,
    "prefill_ms": sum(ms["prefill"]) / len(ms["prefill"]),
    "decode_step_ms": sum(ms["decode_step"]) / len(ms["decode_step"]),
    "decode_step_min_ms": min(ms["decode_step"]), "decode_step_max_ms": max(ms["decode_step"]),
    "decode_steps": len(ms["decode_step"]), "card": smi[0] if smi else None,
}))
"""


# (name, dtype, B, Hq, Hkv, T, S, D, causal): the serving path's decode
# step (granite-3-8b at batch 8), the same step's split kernel alone
# (``flash_decode_partials_cuda`` at its 5 splits: the main loop and the
# partials' stores, no merge), the f32 smoke LM's prefill and decode step,
# and the f32 prefill at full width.
ATTENTION_SHAPES = (
    ("decode bf16 B8 Hq32 Hkv8 T1 S1088 D128", "bfloat16", 8, 32, 8, 1, 1088, 128, False),
    ("decode partials bf16 B8 Hq32 Hkv8 T1 S1088 D128, 5 splits", "bfloat16", 8, 32, 8, 1, 1088,
     128, False),
    ("smoke prefill f32 B4 Hq4 Hkv2 T16 S16 D16 causal", "float32", 4, 4, 2, 16, 16, 16, True),
    ("smoke decode f32 B4 Hq4 Hkv2 T1 S32 D16", "float32", 4, 4, 2, 1, 32, 16, False),
    ("prefill f32 B8 Hq32 Hkv8 T1024 S1024 D128 causal", "float32", 8, 32, 8, 1024, 1024, 128,
     True),
)

_ATTENTION_CHILD = r"""
import json, subprocess, sys
tree, shapes = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, tree + "/src")
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_decode_partials_cuda

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip().splitlines()
gen = torch.Generator(device="cuda").manual_seed(0)
for name, dtype, b, hq, hkv, t, s, d, causal in shapes:
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, t, d, generator=gen, device="cuda").to(dt)
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dt) for _ in range(2))
    if "partials" in name:
        call = lambda: flash_decode_partials_cuda(q, k, v, causal=causal, splits=5)
    else:
        call = lambda: flash_attention_cuda(q, k, v, causal=causal)
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 200
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    events_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    device_ms = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                    for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3 / 20
    graph_ms = None
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(50):
                call()
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            graph.replay()
        end.record()
        end.synchronize()
        graph_ms = start.elapsed_time(end) / 500
    except RuntimeError as e:
        print(f"graph capture failed: {e}", file=sys.stderr)
    print(json.dumps({"tree": tree, "shape": name, "events_ms": events_ms,
                      "device_ms": device_ms, "graph_ms": graph_ms,
                      "card": smi[0] if smi else None}), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--a", required=True, help="root of checkout A")
    ap.add_argument("--b", required=True, help="root of checkout B")
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--gen-len", type=int, default=64)
    ap.add_argument("--attention", action="store_true",
                    help="time flash_attention_cuda at ATTENTION_SHAPES instead of serving")
    ap.add_argument("--match", default="",
                    help="with --attention, only the shapes whose name holds this text")
    args = ap.parse_args(argv)
    for tree in (args.a, args.b):
        if not os.path.isdir(os.path.join(tree, "src", "repro_torch")):
            print(f"compare: {tree} holds no src/repro_torch", file=sys.stderr)
            return 2
    rc = 0
    for tree in (args.a, args.b, args.b, args.a):
        if args.attention:
            shapes = [sh for sh in ATTENTION_SHAPES if args.match in sh[0]]
            cmd = [sys.executable, "-c", _ATTENTION_CHILD, os.path.abspath(tree),
                   json.dumps(shapes)]
        else:
            cmd = [sys.executable, "-c", _CHILD, os.path.abspath(tree), args.arch,
                   str(args.requests), str(args.batch), str(args.prompt_len), str(args.gen_len)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"compare: the run of {tree} failed ({proc.returncode}):\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            rc = 1
            continue
        print("\n".join(lines if args.attention else lines[-1:]), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
