"""Batched serving driver: prefill + greedy decode over a KV cache.

Counterpart of ``repro/launch/serve.py``, with the same arguments, the same
``ServeStats`` and the same schedule: a pool of ``batch`` slots runs in
lockstep, one ``decode_step`` per tick over the whole pool; each round takes
the next ``batch`` requests from the queue, pads idle slots with the round's
last request, prefills, and decodes ``gen_len - 1`` tokens (fewer if the
cache of ``max_len`` positions fills first). Attention in every prefill and
decode step runs through the hand-written flash kernel on a CUDA device.

It runs on ``cuda`` unless the caller asks for ``cpu``; a ``cuda`` request
without a card raises (the CLI exits 2), never falls back. Smoke configs run
in float32, as in the reference; the published ones (``--full``) in their
own dtype (bf16). ``model=`` serves a prebuilt model instead of one built
from ``arch``, ``smoke`` and ``seed`` (the tests hand in the reference's
weights that way).

The prompts are tokens, as the reference's driver draws them, so it refuses
what has none to serve: an encoder-only model (no decode path) and a model
fed embeddings (``input_mode="embeds"``), which the reference's driver
cannot serve either (its prefill finds no "embeds" in the batch). Those
models run through ``Model.forward`` / ``prefill`` / ``decode_step``.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch granite-3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b --full \\
        --batch 8 --prompt-len 1024 --gen-len 64
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.models import Model

__all__ = ["ServeStats", "serve", "resolve_device", "main"]


@dataclasses.dataclass
class ServeStats:
    requests: int
    prefill_tokens: int
    decoded_tokens: int
    wall_s: float
    tokens_per_s: float
    outputs: list[list[int]]


def resolve_device(name: str) -> torch.device:
    """``cuda`` or ``cpu``; ``cuda`` without a card raises."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the run asks for cuda but torch.cuda.is_available() is False; "
            "ask for the CPU with device='cpu' (--device cpu)"
        )
    return torch.device(name)


def _check_servable(cfg) -> None:
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode path")
    if cfg.input_mode != "tokens":
        raise ValueError(
            f"{cfg.name} takes input_mode {cfg.input_mode!r}: the serve driver feeds token "
            "prompts; run its prefill and decode_step on an embeddings batch instead"
        )


def serve(
    *,
    arch: str,
    smoke: bool = True,
    n_requests: int = 8,
    batch: int = 4,
    prompt_len: int = 16,
    gen_len: int = 16,
    max_len: int = 64,
    seed: int = 0,
    device: str = "cuda",
    model: Model | None = None,
) -> ServeStats:
    dev = resolve_device(device)
    if model is not None and model.embed.device.type != dev.type:
        raise ValueError(f"the model lies on {model.embed.device}, serve runs on {dev}")
    cfg = model.cfg if model is not None else (
        get_smoke_config(arch) if smoke else get_config(arch))
    _check_servable(cfg)  # before any model is built
    if model is None:
        if smoke:
            cfg = dataclasses.replace(cfg, dtype="float32")
        model = Model(cfg, device=dev)
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))

    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
        for _ in range(n_requests)
    ]

    def prompt_batch(idx: list[int]) -> torch.Tensor:
        return torch.from_numpy(np.stack([prompts[i] for i in idx])).to(dev, torch.long)

    return _serve_rounds(model, prompt_batch, n_requests=n_requests, batch=batch,
                         prompt_len=prompt_len, gen_len=gen_len, max_len=max_len)


def _serve_rounds(model: Model, prompt_batch, *, n_requests: int, batch: int, prompt_len: int,
                  gen_len: int, max_len: int) -> ServeStats:
    """The schedule of :func:`serve`, timed from its first round.
    ``prompt_batch(idx)`` is ``model.prefill``'s input for the requests
    ``idx`` (one round, padded to ``batch``): a token tensor, or a batch
    that a model fed embeddings takes."""
    pending = list(range(n_requests))
    outputs: list[list[int]] = [[] for _ in range(n_requests)]

    t0 = time.perf_counter()
    decoded = 0
    prefilled = 0
    while pending:
        active = pending[:batch]
        pending = pending[len(active):]
        # Pad the pool to full batch (idle slots decode into a scratch row).
        idx = active + [active[-1]] * (batch - len(active))
        cache, logits = model.prefill(prompt_batch(idx), max_len)
        prefilled += prompt_len * len(active)
        last = torch.argmax(logits[:, -1], dim=-1)
        host = last.tolist()  # one transfer for the whole pool
        for slot, req in enumerate(active):
            outputs[req].append(host[slot])
        pos = prompt_len
        while pos < prompt_len + gen_len - 1 and pos < max_len - 1:
            logits, cache = model.decode_step(cache, last, pos)
            last = torch.argmax(logits, dim=-1)
            host = last.tolist()
            for slot, req in enumerate(active):
                outputs[req].append(host[slot])
            decoded += len(active)
            pos += 1
    wall = time.perf_counter() - t0
    return ServeStats(
        requests=n_requests,
        prefill_tokens=prefilled,
        decoded_tokens=decoded,
        wall_s=wall,
        tokens_per_s=(decoded + prefilled) / max(wall, 1e-9),
        outputs=outputs,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCHS, default="qwen1.5-0.5b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    try:
        stats = serve(
            arch=args.arch, smoke=not args.full, n_requests=args.requests,
            batch=args.batch, prompt_len=args.prompt_len, gen_len=args.gen_len,
            max_len=args.prompt_len + args.gen_len + 8, device=args.device,
        )
    except ValueError as e:  # a model it cannot serve, refused before one is built
        print(f"serve: {e}", file=sys.stderr)
        return 2
    print(
        f"[serve] {stats.requests} requests, {stats.prefill_tokens} prefill + "
        f"{stats.decoded_tokens} decoded tokens in {stats.wall_s:.2f}s "
        f"({stats.tokens_per_s:.0f} tok/s) on {args.device}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
