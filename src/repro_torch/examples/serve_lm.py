"""Batched-serving example: prefill + ring-cache decode on a MoE+SWA arch.

Counterpart of ``examples/serve_lm.py``. Serves the mixtral-family smoke
config (sliding-window attention exercises the ring-buffer KV cache; MoE
exercises expert dispatch at batch size 1 per token). Reports prefill and
decode token throughput.

Usage: PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch <id>] [--requests N]
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.configs import ARCHS
from repro_torch.launch.serve import resolve_device, serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCHS, default="mixtral-8x22b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"serve_lm: {e}", file=sys.stderr)
        return 2
    stats = serve(
        arch=args.arch, smoke=True, n_requests=args.requests, batch=args.batch,
        prompt_len=args.prompt_len, gen_len=args.gen_len,
        max_len=args.prompt_len + args.gen_len + 8, device=args.device,
    )
    print(
        f"[serve_lm] {args.arch}: {stats.requests} requests | "
        f"{stats.prefill_tokens} prefill + {stats.decoded_tokens} decode tokens | "
        f"{stats.wall_s:.2f}s | {stats.tokens_per_s:.0f} tok/s"
    )
    for i, toks in enumerate(stats.outputs[:3]):
        print(f"  request {i}: {toks[:12]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
