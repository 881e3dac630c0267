"""The model: an ArchConfig of attention, Mamba and xLSTM blocks, their FFNs
dense or MoE, over tokens or precomputed embeddings -> init / forward /
prefill / decode.

Counterpart of ``repro/models/model.py`` for every block kind the reference
has: ``attn_mlp`` and ``attn_moe`` (attention, then a SwiGLU MLP or an MoE
FFN, ``models/moe.py``), ``mamba_mlp``, ``mamba_moe`` and ``mamba`` (a Mamba
mixer, ``models/ssm.py``, then the same FFNs or none; jamba's hybrid
stack), and ``mlstm`` and ``slstm`` (xLSTM's self-contained blocks). Where
the reference scans one stacked parameter pytree over periods, the port
holds an ``nn.ModuleList`` with one block per layer and loops over it in
Python: PyTorch runs eagerly, and one block per layer is what the state
dict names (``blocks.<i>.mixer.wq``, ``blocks.<i>.mixer.A_log``,
``blocks.<i>.ffn.router``; an xLSTM block's leaves at its top level,
``blocks.<i>.w_up``, ``blocks.<i>.r_z``).

Inputs, as the reference's ``_embed_in``: ``forward``, ``prefill`` and
``loss_fn`` take a batch dict, ``{"tokens"}`` (B, T) or, for
``input_mode="embeds"`` (the audio encoder's frames, the VLM's patch and
text embeddings, from a stubbed frontend), ``{"embeds"}`` (B, T, d_model),
cast to the model's dtype; with optional ``"positions"``, (B, T) or, under
M-RoPE, (B, T, 3) (t, h, w) ids, else ``arange(T)`` for every row (three
times over under M-RoPE). ``forward`` and ``prefill`` also take a bare token
tensor. The token table ``embed`` exists in either mode: an embeds model
that ties its embeddings unembeds through it, and ``decode_step`` embeds its
tokens through it. Under M-RoPE a decode step's positions are ``(pos, pos,
pos)``, as the reference's (no offset after a compressed image grid).

Training: ``loss_fn`` is the reference's next-token cross entropy over f32
logits. With ``remat`` on (the default, as the reference's), ``forward``
under autograd wraps each block, whatever its kind, in
``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint`` of a period: a block keeps only its input for the
backward pass and runs again there. Attention inside it is differentiable
through the flash kernel (``kernels/ops.py``); the recurrences are torch
operations, which autograd differentiates.

Serving mirrors the reference: ``prefill`` runs the prompt and returns each
layer's cache entry: an attention layer's K/V packed into a linear buffer
(or a ring of ``window`` slots for sliding-window configs), a recurrent
layer's final state (Mamba ``{"h", "conv"}``, mLSTM ``{"C", "n", "m",
"conv"}``, sLSTM ``{"c", "n", "m", "h"}``, whose size does not depend on
``max_len``). ``decode_step`` runs one token for the whole batch. The
reference donates its cache to the compiled step; here the step updates
every entry in place (the new token's K/V into its slot, each state tensor
copied over), so the cache keeps its tensors from step to step. An MoE
block routes a decode step's B tokens as one group, as the reference does.

On a mesh (item 16.6 (i)) the parameters, batch and caches are DTensors
(``runtime/sharding.py::place_params``, ``device_put``) and
``shard_activation`` is the reference's hook (``make_activation_sharder``),
called at its sites: ``embed``, each block's ``residual`` (after the mixer,
after the FFN, an xLSTM block's output), ``moe_in`` and ``logits``; a
decode step only at ``logits``, as the reference's. Each mixer and FFN
reads the whole sequence of its rows (``layers.whole_sequence``); the
embedding, the loss and the recurrences run on each rank's batch rows
(``layers.on_rows``); a decode step writes its cache entries in their own
placements (a cache split on its sequence, ``cache_seq_shard``, by the
rank that holds the slot, into its own shard: ``_write_slot``), and its
attention reads the whole entry with ``kv_len`` (the split rule of
``ops.attention`` on such a cache); serving runs under ``no_grad`` instead
of ``inference_mode``.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
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
    is_dtensor,
    on_rows,
    project_qkv,
    replicated_like,
    rms_norm,
    whole_sequence,
)
from repro_torch.models import ssm
from repro_torch.models.moe import MoE

__all__ = ["Model"]

# The xLSTM blocks, whose leaves sit at the block's top level, as the
# reference's ``_init_block`` returns them.
_XLSTM = ("mlstm", "slstm")


def _params(tensors: dict, device) -> nn.ParameterDict:
    """Uninitialised parameters shaped like ``tensors`` (meta tensors from
    the init functions), on ``device``."""
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(t.shape, dtype=t.dtype, device=device))
        for name, t in tensors.items()
    })


def _leaf_init(kind: str):
    """The init function of a block's own leaves: the xLSTM block's, else
    its mixer's."""
    if kind == "mlstm":
        return ssm.init_mlstm
    if kind == "slstm":
        return ssm.init_slstm
    return init_attention if kind.startswith("attn") else ssm.init_mamba


class Block(nn.Module):
    """One layer of ``kind``: norm, attention or a Mamba mixer (``mixer``),
    then norm and a SwiGLU MLP or an MoE FFN (``ffn``), none for ``mamba``;
    or an xLSTM block (``mlstm``, ``slstm``), its parameters at the top
    level (``params()``)."""

    def __init__(self, cfg: ArchConfig, device, kind: str = "attn_mlp") -> None:
        super().__init__()
        dt = dtype_of(cfg)
        self.kind = kind
        if kind in _XLSTM:
            for name, t in _leaf_init(kind)(None, cfg).items():
                self.register_parameter(
                    name, nn.Parameter(torch.empty(t.shape, dtype=t.dtype, device=device)))
            return
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt, device=device))
        self.mixer = _params(_leaf_init(kind)(None, cfg), device)
        if kind != "mamba":
            self.ln2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt, device=device))
            self.ffn = (MoE(cfg, device) if kind.endswith("_moe")
                        else _params(init_mlp(None, cfg), device))

    def params(self) -> dict:
        """An xLSTM block's parameters by the reference's leaf names."""
        return dict(self.named_parameters(recurse=False))

    @torch.no_grad()
    def init_weights(self, cfg: ArchConfig, generator: torch.Generator) -> None:
        if self.kind in _XLSTM:
            for name, value in _leaf_init(self.kind)(generator, cfg).items():
                getattr(self, name).copy_(value)
            return
        self.ln1.fill_(1.0)
        for name, value in _leaf_init(self.kind)(generator, cfg).items():
            self.mixer[name].copy_(value)
        if self.kind == "mamba":
            return
        self.ln2.fill_(1.0)
        if self.kind.endswith("_moe"):
            self.ffn.init_weights(generator)
        else:
            for name, value in init_mlp(generator, cfg).items():
                self.ffn[name].copy_(value)

    def apply_ffn(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        """x (B, T, d) or (B, d) -> the FFN's output, the same shape. A (B, d)
        step goes to the MoE as (B, 1, d): one group of B tokens. ``shard``
        (the model's hook, over the sequence only) places the MoE's input
        as ``"moe_in"``."""
        if not self.kind.endswith("_moe"):
            return apply_mlp(self.ffn, x)
        if x.dim() == 2:
            return self.ffn(x[:, None, :])[:, 0]
        return self.ffn(x if shard is None else shard(x, "moe_in"))


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
    The ring is the last W tokens rolled by (T - W) % W, the linear cache
    the first tokens padded with zeros (copies either way, of DTensors too).
    """
    t = k.shape[1]
    s = _cache_len(cfg, max_len)
    if cfg.window and t >= s:
        return {name: x[:, -s:].roll((t - s) % s, dims=1) for name, x in (("k", k), ("v", v))}
    n = min(t, s)
    return {name: F.pad(x[:, :n], (0, 0, 0, 0, 0, s - n)) for name, x in (("k", k), ("v", v))}


def _copy_state(entry: dict, state: dict) -> None:
    """A recurrent layer's new state copied into its cache entry's tensors
    (a DTensor state first redistributed to its entry's placements)."""
    for name, value in state.items():
        entry[name].copy_(_like_entry(value, entry[name]))


def _write_slot(entry: torch.Tensor, slot: int, value: torch.Tensor) -> None:
    """``value`` (B, Hkv, D) written in place into slot ``slot`` of the KV
    cache tensor ``entry`` (B, S, Hkv, D). A DTensor cache split on its
    sequence (``cache_seq_shard``) is written by the rank that holds the
    slot alone, into its own shard: ``value`` is laid out as the entry
    without its sequence dim (an activation's redistribution) and the cache
    moves nowhere. Any other DTensor cache takes the value in the slot's
    placements."""
    if not is_dtensor(entry):
        entry[:, slot] = value
        return
    from torch.distributed.tensor import Replicate, Shard

    dims = [p.dim % entry.dim() if p.is_shard() else None for p in entry.placements]
    seq = tuple(i for i, d in enumerate(dims) if d == 1)
    if not seq:
        entry[:, slot] = _like_entry(value, entry[:, slot])
        return
    mesh = entry.device_mesh
    row = tuple(Replicate() if d is None or d == 1 else Shard(d - (d > 1)) for d in dims)
    local, value = entry.to_local(), value.redistribute(mesh, row).to_local()
    first = ops.shard_offset(mesh, seq, local.shape[1])
    if first <= slot < first + local.shape[1]:
        local[:, slot - first] = value


def _like_entry(value: torch.Tensor, entry: torch.Tensor) -> torch.Tensor:
    """``value`` laid out as the cache tensor ``entry`` it is written into:
    itself for plain tensors, else redistributed to the entry's placements
    (an in-place write keeps its target's placements)."""
    if not is_dtensor(entry):
        return value
    return value.redistribute(entry.device_mesh, entry.placements)


def _serving(fn):
    """Run a serving method under ``torch.inference_mode``; a model placed on
    a mesh under ``torch.no_grad`` instead, since a DTensor view of a cache
    made outside inference mode cannot be taken inside it (its version
    counter). Neither records a graph: the numbers are the same."""

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        mode = torch.no_grad() if is_dtensor(self.embed) else torch.inference_mode()
        with mode:
            return fn(self, *args, **kwargs)

    return call


def _identity_shard(x: torch.Tensor, name: str) -> torch.Tensor:
    return x


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows for ``tokens``; on a mesh each rank's tokens against
    the whole table."""
    return on_rows(lambda p, tok: p["table"][tok.long()], (tokens,), {"table": table})


def _nll(_, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logsumexp less the gold logit, (B, T) from f32 logits (B, T, V)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


class Model(nn.Module):
    """An LM of the config's block kinds (attention, Mamba, xLSTM; FFNs dense
    or MoE). Parameters are created
    uninitialised on ``device`` (CUDA unless the caller asks for the CPU);
    ``init_weights`` fills them from a generator, or ``load_state_dict`` from
    ``convert.model_state_from_reference``.
    """

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda",
                 remat: bool = True, shard_activation=None) -> None:
        super().__init__()
        cfg.validate()
        check_supported(cfg)
        self.cfg = cfg
        self.remat = remat
        # ``shard(x, name)``: the reference's hook (runtime/sharding.py::
        # make_activation_sharder), the identity by default.
        self.shard = shard_activation or _identity_shard
        dt = dtype_of(cfg)
        self.blocks = nn.ModuleList(Block(cfg, device, kind) for kind in cfg.block_kinds())
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
    def _embed_in(self, inputs) -> tuple[torch.Tensor, torch.Tensor]:
        """(x (B, T, d), positions) from a token tensor or a batch dict (the
        module docstring's inputs)."""
        cfg = self.cfg
        batch = inputs if isinstance(inputs, dict) else {"tokens": inputs}
        if cfg.input_mode == "embeds":
            if "embeds" not in batch:
                raise ValueError(f"{cfg.name} takes input_mode 'embeds': a batch with "
                                 "\"embeds\" (B, T, d_model), not tokens")
            x = batch["embeds"].to(dtype_of(cfg))
        else:
            x = _lookup(self.embed, batch["tokens"])
        b, t = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(t, device=x.device).expand(b, t)
            if cfg.rope == "mrope":
                positions = positions[..., None].expand(b, t, 3)
            positions = replicated_like(positions, x)
        return self.shard(x, "embed"), positions

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        w = self.embed.T if self.cfg.tie_embeddings else self.unembed
        return self.shard(x.float() @ w.float(), "logits")

    def _block(self, block: Block, x: torch.Tensor, positions: torch.Tensor):
        """One layer over the sequence: x (B, T, d) -> (x, cache entry): an
        attention layer's (k, v) (B, T, KV, hd), to be packed by
        ``_kv_to_cache``; a recurrent layer's final state."""
        cfg, shard = self.cfg, self.shard
        # On a mesh each mixer and FFN reads the whole sequence
        # (``whole_sequence``; the identity on plain tensors), and its output
        # joins the residual stream in the stream's layout.
        if block.kind in _XLSTM:
            apply = ssm.apply_mlstm if block.kind == "mlstm" else ssm.apply_slstm
            x, entry = apply(block.params(), cfg, whole_sequence(x))
            return shard(x, "residual"), entry
        xn = rms_norm(whole_sequence(x), block.ln1, cfg.norm_eps)
        if block.kind.startswith("attn"):
            h, entry = apply_attention(block.mixer, cfg, xn, whole_sequence(positions))
        else:
            h, entry = ssm.apply_mamba(block.mixer, cfg, xn)
        x = shard(x + whole_sequence(h), "residual")
        if block.kind != "mamba":
            xn = rms_norm(whole_sequence(x), block.ln2, cfg.norm_eps)
            x = shard(x + whole_sequence(block.apply_ffn(xn, shard)), "residual")
        return x, entry

    # ---- forward ------------------------------------------------------------
    def _block_out(self, block: Block, x: torch.Tensor, positions: torch.Tensor):
        return self._block(block, x, positions)[0]

    def forward(self, inputs) -> torch.Tensor:
        """tokens (B, T), or a batch dict -> logits (B, T, V), f32."""
        x, positions = self._embed_in(inputs)
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
        return self._unembed(rms_norm(whole_sequence(x), self.ln_f, self.cfg.norm_eps))

    def loss_fn(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Mean cross entropy of ``batch`` ({"tokens"} or {"embeds"}, optional
        "positions", "labels" (B, T), optional "loss_mask") from f32 logits:
        logsumexp less the gold logit, masked, over the mask's sum clamped to
        at least 1. -> (loss, {"loss", "tokens"}), 0-d f32 tensors on the
        device."""
        logits = self.forward(batch)  # (B, T, V) f32
        # Row by row; on a mesh each rank's rows whole (the vocab gathered:
        # a vocab shard is uneven where the axis does not divide V).
        nll = on_rows(_nll, (logits, batch["labels"]))
        mask = batch.get("loss_mask")
        mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
        tokens = torch.sum(mask)
        loss = torch.sum(nll * mask) / torch.clamp(tokens, min=1.0)
        return loss, {"loss": loss, "tokens": tokens}

    # ---- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> list[dict]:
        """Each layer's empty entry: ``{"k", "v"}`` of zeros, (B, S, KV, hd),
        for attention; a recurrent layer's zero state, whose size does not
        depend on ``max_len``."""
        cfg = self.cfg
        device = self.embed.device
        shape = (batch, _cache_len(cfg, max_len), cfg.n_kv_heads, cfg.head_dim)

        def entry(kind: str) -> dict:
            if kind.startswith("attn"):
                return {"k": self.embed.new_zeros(shape), "v": self.embed.new_zeros(shape)}
            if kind == "mlstm":
                return ssm.init_state_mlstm(cfg, batch, device)
            if kind == "slstm":
                return ssm.init_state_slstm(cfg, batch, device)
            return ssm.init_state_mamba(cfg, batch, device)

        return [entry(block.kind) for block in self.blocks]

    @_serving
    def prefill(self, inputs, max_len: int):
        """Run the prompt: tokens (B, T), or a batch dict; returns (cache,
        logits (B, T, V))."""
        x, positions = self._embed_in(inputs)
        cache = []
        for block in self.blocks:
            x, entry = self._block(block, x, positions)
            if block.kind.startswith("attn"):
                entry = _kv_to_cache(self.cfg, *entry, max_len)
            cache.append(entry)
        return cache, self._unembed(rms_norm(whole_sequence(x), self.ln_f, self.cfg.norm_eps))

    def _decode_block(self, block: Block, entry: dict, x_t: torch.Tensor,
                      positions_t: torch.Tensor, pos: int):
        """One layer of a decode step at ``pos`` (``positions_t`` (B, 1), or
        (B, 1, 3) under M-RoPE, holds it on the device), updating the layer's cache ``entry`` in place: an
        attention layer writes the step's K/V into slot ``pos % S``, a
        recurrent layer copies its new state over the old. x_t (B, d) ->
        (B, d)."""
        cfg = self.cfg
        if block.kind in _XLSTM:
            step = ssm.step_mlstm if block.kind == "mlstm" else ssm.step_slstm
            x_t, state = step(block.params(), cfg, x_t, entry)
            _copy_state(entry, state)
            return x_t
        xn = rms_norm(x_t, block.ln1, cfg.norm_eps)
        if block.kind.startswith("attn"):
            h = self._decode_attention(block, entry, xn, positions_t, pos)
        else:
            h, state = ssm.step_mamba(block.mixer, cfg, xn, entry)
            _copy_state(entry, state)
        x_t = x_t + h
        if block.kind == "mamba":
            return x_t
        return x_t + block.apply_ffn(rms_norm(x_t, block.ln2, cfg.norm_eps))

    def _decode_attention(self, block: Block, entry: dict, xn: torch.Tensor,
                          positions_t: torch.Tensor, pos: int) -> torch.Tensor:
        """The attention of a decode step: xn (B, d) normed -> (B, d)."""
        cfg = self.cfg
        b = xn.shape[0]
        q, k, v = project_qkv(block.mixer, cfg, xn[:, None, :], positions_t)
        s = entry["k"].shape[1]
        slot = pos % s
        _write_slot(entry["k"], slot, k[:, 0])
        _write_slot(entry["v"], slot, v[:, 0])
        # Slots [0, kv_len) hold exactly the valid past tokens, in the linear
        # and the ring layout alike (RoPE was applied at absolute positions,
        # and attention does not depend on the keys' order). The whole entry
        # goes in: a cache split on its sequence takes the split rule there.
        out = ops.attention(
            q.transpose(1, 2),
            entry["k"].transpose(1, 2),
            entry["v"].transpose(1, 2),
            causal=False,
            kv_len=min(pos + 1, s),
        )
        return out.reshape(b, cfg.n_heads * cfg.head_dim) @ block.mixer["wo"]

    @_serving
    def decode_step(self, cache: list[dict], tokens: torch.Tensor, pos: int):
        """One token step for the batch: tokens (B,), ``pos`` the absolute
        position (a host int; under M-RoPE each of the three ids). Updates
        every entry of ``cache`` in place (the step's K/V into slot ``pos %
        S``, each recurrent state copied over) and returns (logits (B, V),
        cache)."""
        x_t = _lookup(self.embed, tokens)  # (B, d)
        shape = (x_t.shape[0], 1, 3) if self.cfg.rope == "mrope" else (x_t.shape[0], 1)
        positions_t = replicated_like(
            torch.full(shape, pos, dtype=torch.long, device=x_t.device), x_t)
        for block, entry in zip(self.blocks, cache, strict=True):
            x_t = self._decode_block(block, entry, x_t, positions_t, pos)
        logits = self._unembed(rms_norm(x_t, self.ln_f, self.cfg.norm_eps))
        return logits, cache
