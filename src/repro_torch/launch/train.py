"""Fault-tolerant training driver.

Counterpart of ``repro/launch/train.py``, with its arguments and defaults:
config -> ``Model`` -> train step (``runtime/steps.py``: gradient, clipping,
schedule, AdamW, all in place) -> synthetic data with prefetch on a side
CUDA stream -> async atomic checkpointing -> exact resume -> straggler
monitoring. Smoke configs train in f32 without remat; the published ones
(``--full``) in their own dtype (bf16) with remat on. Attention runs through
the flash kernel forward and its torch backward on a card.

Fault-tolerance contract, as the reference's:

- ``--resume`` restores the parameters, the optimizer state and the data
  cursor from the latest complete checkpoint; the step sequence is
  bit-identical to an uninterrupted run.
- A straggler trigger checkpoints at once (``runtime/straggler.py``).

It runs on ``cuda`` unless the caller asks for ``cpu``; ``cuda`` without a
card raises (the CLI exits 2), never falls back. ``--mesh`` on one device
runs without a mesh, as the reference does; over several GPUs it is
ROADMAP.md queue 1, item 12, and raises. After each step the driver reads
the loss to the host once, and times the step with a CUDA event pair (the
host clock on the CPU).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 20 --batch 8 --seq 1024
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import Prefetch, SyntheticEmbeds, SyntheticLM
from repro_torch.launch.serve import resolve_device
from repro_torch.models import Model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = ["main", "train"]


def _make_data(cfg, batch: int, seq: int, seed: int):
    """The synthetic stream ``cfg`` trains on: embeddings (and M-RoPE
    positions) for ``input_mode="embeds"``, tokens otherwise."""
    if cfg.input_mode == "embeds":
        return SyntheticEmbeds(d_model=cfg.d_model, vocab=cfg.vocab, batch=batch, seq=seq,
                               mrope=cfg.rope == "mrope", seed=seed)
    return SyntheticLM(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed)


class _StepTimer:
    """A CUDA event pair on a card, the host clock on the CPU."""

    def __init__(self, device: torch.device) -> None:
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._cuda:
            self._end.record()
        else:
            self._t1 = time.perf_counter()

    def seconds(self) -> float:
        """After the step's results were read (the events have completed)."""
        if self._cuda:
            self._end.synchronize()
            return self._start.elapsed_time(self._end) / 1e3
        return self._t1 - self._t0


def train(
    *,
    arch: str,
    smoke: bool = True,
    steps: int = 100,
    stop_after: int | None = None,  # simulate interruption at this step
    batch: int = 8,
    seq: int = 64,
    lr: float = 1e-3,
    accum: int = 1,
    checkpoint_dir: str | None = None,
    save_every: int = 50,
    resume: bool = False,
    use_mesh: bool = False,
    log_every: int = 10,
    seed: int = 0,
    moment_dtype: str = "float32",
    device: str = "cuda",
) -> dict:
    """Train ``arch`` for ``steps`` steps (or until ``stop_after``).
    -> {"first_loss", "final_loss" (mean of the last 5), "steps", "wall_s",
    "losses", "grad_norms", "step_ms", "save_s" (host seconds inside each
    ``save``), "write_s" (each save's file writing, on its thread or not),
    "restore_s", "model", "opt_state", "params" (the state dict)}.
    """
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if smoke:
        # Keep smoke runs fast but honest: small width, real block structure.
        cfg = dataclasses.replace(cfg, dtype="float32")
    if use_mesh and dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "--mesh over several GPUs is placement (ROADMAP.md queue 1, item 12); "
            "on one device the run needs no mesh"
        )

    model = Model(cfg, device=dev, remat=not smoke)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    opt = AdamW(moment_dtype=moment_dtype)
    sched = functools.partial(
        warmup_cosine, peak_lr=lr, warmup_steps=max(1, steps // 20), total_steps=steps
    )
    step_fn = make_train_step(model, opt, sched, accum=accum)
    opt_state = opt.init(dict(model.named_parameters()))
    start_step = 0

    def payload(cursor: int) -> dict:
        return {"params": model.state_dict(), "opt": opt_state, "cursor": cursor}

    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    restore_s = None
    if resume and ckpt and ckpt.latest_step() is not None:
        t0 = time.perf_counter()
        restored_step, restored = ckpt.restore(payload(0))
        model.load_state_dict(restored["params"])
        opt_state = restored["opt"]
        start_step = int(restored["cursor"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        print(f"[train] resumed from step {restored_step} (cursor {start_step}) in "
              f"{restore_s:.2f} s")

    data = _make_data(cfg, batch, seq, seed)
    prefetch = Prefetch(data.batch_at, start_step=start_step, device=dev)
    monitor = StragglerMonitor()
    losses: list[float] = []
    step_ms: list[float] = []
    grad_norms: list[torch.Tensor] = []
    save_s: list[float] = []

    def save(step: int, cursor: int, blocking: bool = False) -> None:
        t0 = time.perf_counter()
        ckpt.save(step, payload(cursor), blocking=blocking)
        save_s.append(time.perf_counter() - t0)

    t_start = time.time()
    stop_at = min(steps, stop_after) if stop_after is not None else steps
    try:
        for step_idx, batch_data in prefetch:
            if step_idx >= stop_at:
                break
            timer = _StepTimer(dev)
            opt_state, metrics = step_fn(opt_state, batch_data)
            timer.stop()
            losses.append(float(metrics["loss"]))  # the step's one host read
            dt = timer.seconds()
            step_ms.append(dt * 1e3)
            grad_norms.append(metrics["grad_norm"])
            if monitor.record(dt) and ckpt:
                print(f"[train] straggler trigger at step {step_idx}; checkpointing")
                save(step_idx, step_idx + 1)
            # The last step's save is the blocking one after the loop (the
            # reference writes that step twice).
            if ckpt and save_every and (step_idx + 1) % save_every == 0 and step_idx + 1 < stop_at:
                save(step_idx + 1, step_idx + 1)
            if log_every and step_idx % log_every == 0:
                print(
                    f"[train] step {step_idx} loss {losses[-1]:.4f} "
                    f"({dt * 1e3:.0f} ms/step, lr {float(metrics['lr']):.2e})",
                    flush=True,
                )
    finally:
        prefetch.close()
        if ckpt:
            ckpt.wait()
    wall = time.time() - t_start
    if ckpt:
        save(stop_at, stop_at, blocking=True)
    return {
        "first_loss": losses[0] if losses else float("nan"),
        "final_loss": float(np.mean(losses[-5:])) if losses else float("nan"),
        "steps": len(losses),
        "wall_s": wall,
        "losses": losses,
        "grad_norms": torch.stack(grad_norms).tolist() if grad_norms else [],
        "step_ms": step_ms,
        "save_s": save_s,
        "write_s": list(ckpt.write_s) if ckpt else [],
        "restore_s": restore_s,
        "model": model,
        "opt_state": opt_state,
        "params": model.state_dict(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCHS, default="qwen1.5-0.5b")
    ap.add_argument("--full", action="store_true", help="use the full (non-smoke) config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"train: {e}", file=sys.stderr)
        return 2
    out = train(
        arch=args.arch, smoke=not args.full, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, accum=args.accum,
        checkpoint_dir=args.checkpoint_dir, save_every=args.save_every,
        resume=args.resume, use_mesh=args.mesh, seed=args.seed, device=args.device,
    )
    print(
        f"[train] done: {out['steps']} steps in {out['wall_s']:.1f}s, "
        f"loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} on {args.device}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
