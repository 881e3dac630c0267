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
    args = ap.parse_args(argv)
    for tree in (args.a, args.b):
        if not os.path.isdir(os.path.join(tree, "src", "repro_torch")):
            print(f"compare: {tree} holds no src/repro_torch", file=sys.stderr)
            return 2
    rc = 0
    for tree in (args.a, args.b, args.b, args.a):
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, os.path.abspath(tree), args.arch,
             str(args.requests), str(args.batch), str(args.prompt_len), str(args.gen_len)],
            capture_output=True, text=True,
        )
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"compare: the run of {tree} failed ({proc.returncode}):\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            rc = 1
            continue
        print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
