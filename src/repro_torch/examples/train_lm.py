"""End-to-end training driver example.

Counterpart of ``examples/train_lm.py``. Default: a ~5M-param qwen-family
model for 200 steps on synthetic data, with checkpoints and exact resume.
``--size 100m --steps 300`` is the assignment-scale run (~110M params, a
few hundred steps) for real hardware; the driver is identical. The step
(``runtime/steps.py``) updates the model's parameters and the optimizer
state in place; attention runs through the flash kernel on a card. The
checkpoints go to ``/tmp/repro_torch_train_lm`` unless ``--ckpt`` says
otherwise (the reference's are ``/tmp/repro_train_lm``).

Usage:
  PYTHONPATH=src python -m repro_torch.examples.train_lm [--size 5m|25m|100m] [--steps N]
  PYTHONPATH=src python -m repro_torch.examples.train_lm --resume   # continue last run
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.data import Prefetch, SyntheticLM
from repro_torch.launch.serve import resolve_device
from repro_torch.models import Model
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.straggler import StragglerMonitor

SIZES = {
    # name: (layers, d_model, heads, kv, d_ff, vocab) — ~5M / ~25M / ~110M
    "5m": (4, 256, 4, 2, 704, 4096),
    "25m": (8, 512, 8, 4, 1408, 8192),
    "100m": (12, 768, 12, 4, 2048, 32768),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", choices=SIZES, default="5m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="/tmp/repro_torch_train_lm")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"train_lm: {e}", file=sys.stderr)
        return 2

    L, d, h, kv, ff, v = SIZES[args.size]
    cfg = ArchConfig(
        name=f"train-lm-{args.size}", family="dense", n_layers=L, d_model=d,
        n_heads=h, n_kv_heads=kv, head_dim=d // h, d_ff=ff, vocab=v,
        dtype="float32",
    )
    model = Model(cfg, device=dev, remat=False)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    n_params = cfg.param_counts()["total"]
    print(f"[train_lm] {cfg.name}: ~{n_params / 1e6:.1f}M params")

    opt = AdamW()
    sched = functools.partial(
        warmup_cosine, peak_lr=args.lr,
        warmup_steps=max(10, args.steps // 20), total_steps=args.steps,
    )
    step_fn = make_train_step(model, opt, sched)
    opt_state = opt.init(dict(model.named_parameters()))

    def payload(cursor: int) -> dict:
        return {"params": model.state_dict(), "opt": opt_state, "cursor": cursor}

    start = 0
    ckpt = Checkpointer(args.ckpt, keep=2)
    if args.resume and ckpt.latest_step() is not None:
        _, restored = ckpt.restore(payload(0))
        model.load_state_dict(restored["params"])
        opt_state, start = restored["opt"], int(restored["cursor"])
        print(f"[train_lm] resumed at step {start}")

    data = SyntheticLM(vocab=cfg.vocab, batch=args.batch, seq=args.seq)
    prefetch = Prefetch(data.batch_at, start_step=start, device=dev)
    monitor = StragglerMonitor()
    t0 = time.time()
    tokens = 0
    loss = float("nan")
    try:
        for i, batch in prefetch:
            if i >= args.steps:
                break
            ts = time.time()
            opt_state, m = step_fn(opt_state, batch)
            loss = float(m["loss"])  # the step's one host read
            dt = time.time() - ts
            monitor.record(dt)
            tokens += args.batch * args.seq
            if i % 20 == 0:
                print(
                    f"[train_lm] step {i:>4} loss {loss:.4f} "
                    f"{args.batch * args.seq / dt:,.0f} tok/s", flush=True,
                )
            if (i + 1) % 100 == 0:
                ckpt.save(i + 1, payload(i + 1))
    finally:
        prefetch.close()
        ckpt.wait()
    ckpt.save(args.steps, payload(args.steps), blocking=True)
    wall = time.time() - t0
    print(f"[train_lm] {tokens:,} tokens in {wall:.1f}s ({tokens / wall:,.0f} tok/s); "
          f"final loss {loss:.4f}; checkpoint at {args.ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
