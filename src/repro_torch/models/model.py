"""The LM: an ArchConfig of attention blocks with a dense MLP or an MoE FFN
-> init / forward / prefill / decode.

Counterpart of ``repro/models/model.py`` for the block kinds ``attn_mlp``
(the dense configs) and ``attn_moe`` (mixtral-8x22b, dbrx-132b; the FFN is
``models/moe.py``). Where the reference scans one stacked parameter pytree
over periods, the port holds an ``nn.ModuleList`` with one block per layer
and loops over it in Python: PyTorch runs eagerly, and one block per layer
is what the state dict names (``blocks.<i>.mixer.wq``,
``blocks.<i>.ffn.router``, ...). The other block kinds (Mamba, xLSTM) raise
``NotImplementedError``: they are ROADMAP.md queue 1, item 16.

Training: ``loss_fn`` is the reference's next-token cross entropy over f32
logits. With ``remat`` on (the default, as the reference's), ``forward``
under autograd wraps each block in ``torch.utils.checkpoint``, the
counterpart of the reference's ``jax.checkpoint`` of a period: a block keeps
only its input for the backward pass and runs again there. Attention inside
it is differentiable through the flash kernel (``kernels/ops.py``).

Serving mirrors the reference: ``prefill`` runs the prompt and packs each
layer's K/V into the decode cache (a linear buffer, or a ring of ``window``
slots for sliding-window configs); ``decode_step`` runs one token for the
whole batch. The reference donates its cache to the compiled step; here the
step writes the new token's K/V into its slot in place and attends over the
cache's valid slots through views, so a step allocates no cache. An MoE
block routes a decode step's B tokens as one group, as the reference does.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    apply_attention,
    apply_mlp,
    check_supported,
    dtype_of,
    init_attention,
    init_dense,
    init_mlp,
    project_qkv,
    rms_norm,
)
from repro_torch.models.moe import MoE

__all__ = ["Model"]


def _params(tensors: dict, device) -> nn.ParameterDict:
    """Uninitialised parameters shaped like ``tensors`` (meta tensors from
    the init functions), on ``device``."""
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(t.shape, dtype=t.dtype, device=device))
        for name, t in tensors.items()
    })


class Block(nn.Module):
    """One layer: norm, attention, norm, and a SwiGLU MLP (``attn_mlp``) or
    an MoE FFN (``attn_moe``)."""

    def __init__(self, cfg: ArchConfig, device, kind: str = "attn_mlp") -> None:
        super().__init__()
        dt = dtype_of(cfg)
        self.kind = kind
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt, device=device))
        self.mixer = _params(init_attention(None, cfg), device)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt, device=device))
        self.ffn = MoE(cfg, device) if kind == "attn_moe" else _params(init_mlp(None, cfg), device)

    @torch.no_grad()
    def init_weights(self, cfg: ArchConfig, generator: torch.Generator) -> None:
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        for name, value in init_attention(generator, cfg).items():
            self.mixer[name].copy_(value)
        if self.kind == "attn_moe":
            self.ffn.init_weights(generator)
        else:
            for name, value in init_mlp(generator, cfg).items():
                self.ffn[name].copy_(value)

    def apply_ffn(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, d) or (B, d) -> the FFN's output, the same shape. A (B, d)
        step goes to the MoE as (B, 1, d): one group of B tokens."""
        if self.kind != "attn_moe":
            return apply_mlp(self.ffn, x)
        return self.ffn(x) if x.dim() == 3 else self.ffn(x[:, None, :])[:, 0]


def _route_contexts():
    """``checkpoint``'s contexts: none for the forward, the forward's
    ``force_impl`` state again for the recomputation."""
    return contextlib.nullcontext(), ops.reenter_impl()


def _cache_len(cfg: ArchConfig, max_len: int) -> int:
    return min(cfg.window, max_len) if cfg.window else max_len


def _kv_to_cache(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor, max_len: int) -> dict:
    """Pack prefill K/V (B, T, KV, hd) into the decode cache layout.

    The token at absolute position p lives at slot p (linear cache) or
    p % W (sliding-window ring buffer); decode continues the same convention.
    """
    b, t, kv, hd = k.shape
    s = _cache_len(cfg, max_len)
    ck = k.new_zeros((b, s, kv, hd))
    cv = v.new_zeros((b, s, kv, hd))
    if cfg.window and t >= s:
        pos = torch.arange(t - s, t, device=k.device) % s
        ck[:, pos] = k[:, -s:]
        cv[:, pos] = v[:, -s:]
    else:
        n = min(t, s)
        ck[:, :n] = k[:, :n]
        cv[:, :n] = v[:, :n]
    return {"k": ck, "v": cv}


class Model(nn.Module):
    """An attention LM, its FFNs dense or MoE. Parameters are created
    uninitialised on ``device`` (CUDA unless the caller asks for the CPU);
    ``init_weights`` fills them from a generator, or ``load_state_dict`` from
    ``convert.model_state_from_reference``.
    """

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda",
                 remat: bool = True) -> None:
        super().__init__()
        cfg.validate()
        kinds = cfg.block_kinds()
        other = sorted(set(kinds) - {"attn_mlp", "attn_moe"})
        if other:
            raise NotImplementedError(
                f"{cfg.name}: block kinds {other} are not ported yet (Mamba and xLSTM "
                "layers are ROADMAP.md queue 1, item 16); the port runs attn_mlp and attn_moe"
            )
        if cfg.input_mode != "tokens":
            raise NotImplementedError(
                f"{cfg.name}: input_mode {cfg.input_mode!r} is not ported yet "
                "(ROADMAP.md queue 1, item 16)"
            )
        check_supported(cfg)
        self.cfg = cfg
        self.remat = remat
        dt = dtype_of(cfg)
        self.blocks = nn.ModuleList(Block(cfg, device, kind) for kind in kinds)
        self.ln_f = nn.Parameter(torch.ones(cfg.d_model, dtype=dt, device=device))
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model), dtype=dt, device=device))
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(
                torch.empty((cfg.d_model, cfg.vocab), dtype=dt, device=device))

    # ---- parameters -------------------------------------------------------
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Truncated-normal weights as the reference's ``init_dense``, ones
        for the norms, zeros for the biases, drawn from ``generator``, which
        must live on the model's device."""
        if generator.device.type != self.embed.device.type:
            raise ValueError(
                f"generator on {generator.device}, model on {self.embed.device}")
        cfg = self.cfg
        dt = dtype_of(cfg)
        for block in self.blocks:
            block.init_weights(cfg, generator)
        self.ln_f.fill_(1.0)
        self.embed.copy_(init_dense(generator, cfg.vocab, cfg.d_model, dt))
        if not cfg.tie_embeddings:
            self.unembed.copy_(init_dense(generator, cfg.d_model, cfg.vocab, dt))

    # ---- shared pieces ----------------------------------------------------
    def _embed_in(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.embed[tokens]
        b, t = tokens.shape
        positions = torch.arange(t, device=tokens.device).expand(b, t)
        return x, positions

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        w = self.embed.T if self.cfg.tie_embeddings else self.unembed
        return x.float() @ w.float()

    def _block(self, block: Block, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        h, kv = apply_attention(block.mixer, cfg, rms_norm(x, block.ln1, cfg.norm_eps),
                                positions)
        x = x + h
        x = x + block.apply_ffn(rms_norm(x, block.ln2, cfg.norm_eps))
        return x, kv

    # ---- forward ------------------------------------------------------------
    def _block_out(self, block: Block, x: torch.Tensor, positions: torch.Tensor):
        return self._block(block, x, positions)[0]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) -> logits (B, T, V), f32."""
        x, positions = self._embed_in(tokens)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                # The block is deterministic (no dropout): no RNG state to
                # keep. Its recomputation, on autograd's thread, takes the
                # routes this forward took.
                x = checkpoint(self._block_out, block, x, positions, use_reentrant=False,
                               preserve_rng_state=False, context_fn=_route_contexts)
            else:
                x = self._block_out(block, x, positions)
        return self._unembed(rms_norm(x, self.ln_f, self.cfg.norm_eps))

    def loss_fn(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Mean next-token cross entropy of ``batch`` ({"tokens", "labels"}
        (B, T), optional "loss_mask"), from f32 logits: logsumexp less the
        gold logit, masked, over the mask's sum clamped to at least 1.
        -> (loss, {"loss", "tokens"}), 0-d f32 tensors on the device."""
        logits = self.forward(batch["tokens"].long())  # (B, T, V) f32
        labels = batch["labels"].long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = logz - gold
        mask = batch.get("loss_mask")
        mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
        tokens = torch.sum(mask)
        loss = torch.sum(nll * mask) / torch.clamp(tokens, min=1.0)
        return loss, {"loss": loss, "tokens": tokens}

    # ---- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> list[dict]:
        """One ``{"k", "v"}`` of zeros, (B, S, KV, hd), per layer."""
        cfg = self.cfg
        shape = (batch, _cache_len(cfg, max_len), cfg.n_kv_heads, cfg.head_dim)
        return [
            {"k": self.embed.new_zeros(shape), "v": self.embed.new_zeros(shape)}
            for _ in self.blocks
        ]

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, max_len: int):
        """Run the prompt tokens (B, T); returns (cache, logits (B, T, V))."""
        x, positions = self._embed_in(tokens)
        cache = []
        for block in self.blocks:
            x, (k, v) = self._block(block, x, positions)
            cache.append(_kv_to_cache(self.cfg, k, v, max_len))
        return cache, self._unembed(rms_norm(x, self.ln_f, self.cfg.norm_eps))

    def _decode_block(self, block: Block, entry: dict, x_t: torch.Tensor,
                      positions_t: torch.Tensor, pos: int):
        """One layer of a decode step at ``pos`` (``positions_t`` (B, 1) holds
        it on the device): writes the step's K/V into slot ``pos % S`` of the
        layer's cache ``entry`` in place. x_t (B, d) -> (B, d)."""
        cfg = self.cfg
        b = x_t.shape[0]
        xn = rms_norm(x_t, block.ln1, cfg.norm_eps)[:, None, :]  # (B, 1, d)
        q, k, v = project_qkv(block.mixer, cfg, xn, positions_t)
        s = entry["k"].shape[1]
        slot = pos % s
        entry["k"][:, slot] = k[:, 0]
        entry["v"][:, slot] = v[:, 0]
        # Slots [0, kv_len) hold exactly the valid past tokens, in the linear
        # and the ring layout alike (RoPE was applied at absolute positions,
        # and attention does not depend on the keys' order).
        kv_len = min(pos + 1, s)
        out = ops.attention(
            q.transpose(1, 2),
            entry["k"][:, :kv_len].transpose(1, 2),
            entry["v"][:, :kv_len].transpose(1, 2),
            causal=False,
        )
        x_t = x_t + out.reshape(b, cfg.n_heads * cfg.head_dim) @ block.mixer["wo"]
        return x_t + block.apply_ffn(rms_norm(x_t, block.ln2, cfg.norm_eps))

    @torch.inference_mode()
    def decode_step(self, cache: list[dict], tokens: torch.Tensor, pos: int):
        """One token step for the batch: tokens (B,), ``pos`` the absolute
        position (a host int). Writes the step's K/V into slot ``pos % S`` of
        ``cache`` in place and returns (logits (B, V), cache)."""
        x_t = self.embed[tokens]  # (B, d)
        positions_t = torch.full((x_t.shape[0], 1), pos, dtype=torch.long, device=x_t.device)
        for block, entry in zip(self.blocks, cache, strict=True):
            x_t = self._decode_block(block, entry, x_t, positions_t, pos)
        logits = self._unembed(rms_norm(x_t, self.ln_f, self.cfg.norm_eps))
        return logits, cache
