"""Quickstart: the three things the framework does, in a minute.

Counterpart of ``examples/quickstart.py``:

1. Run a slice of the Mirovia/Altis suite and print the Fig-5-style table.
2. Train a tiny LM for a few steps (loss goes down).
3. Serve it with batched greedy decoding.

Usage: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core import run_suite
from repro_torch.launch.serve import resolve_device, serve
from repro_torch.launch.train import train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"quickstart: {e}", file=sys.stderr)
        return 2

    print("=== 1. Mirovia suite slice (preset 0) ===")
    records = run_suite(
        names=["gemm_bf16_nn", "srad", "where", "softmax"],
        preset=0, iters=3, warmup=1, verbose=False, device=args.device,
    )
    for r in records:
        if r.status != "ok":
            print(f"  {r.name:<28} ERROR: {r.error}")
            continue
        print(
            f"  {r.name:<28} {r.us_per_call:>10.1f} us  "
            f"compute|{'#' * r.compute_util10:<10}| memory|{'#' * r.memory_util10:<10}|"
        )

    print("=== 2. Train a small qwen-family LM ===")
    out = train(arch="qwen1.5-0.5b", smoke=True, steps=40, batch=8, seq=32,
                lr=2e-3, log_every=10, device=args.device)
    print(f"  loss {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
          f"in {out['wall_s']:.1f}s")

    print("=== 3. Serve it (batched greedy decode) ===")
    stats = serve(arch="qwen1.5-0.5b", smoke=True, n_requests=4, batch=2,
                  prompt_len=8, gen_len=8, max_len=24, device=args.device)
    print(f"  {stats.tokens_per_s:.0f} tok/s over {stats.requests} requests")
    print(f"  sample output tokens: {stats.outputs[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
