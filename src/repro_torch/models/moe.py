"""Mixture-of-Experts FFN with GShard-style grouped one-hot dispatch.

Counterpart of ``repro/models/moe.py``, function for function, on tensors:
tokens are split into groups of ``moe_group_size`` (over the flattened
B·T tokens, so a group may cross batch rows); each group routes its tokens
into per-expert capacity buffers with a one-hot dispatch tensor; the expert
FFNs run as batched products over the expert axis, and a combine product
scatters the results back. Top-k routing with the selected experts'
softmax weights renormalized (Mixtral's scheme); tokens over capacity are
dropped.

The reference's arithmetic, kept exactly:

- the router is f32 in a bf16 model, and routes f32 activations;
- selection is ``weights >= k-th largest``, so a tie selects more than k
  experts;
- capacity is ``max(1, round(k·g·capacity_factor / E))`` with Python's
  ``round`` (halves to even);
- with ``moe_split`` > 1 each combine weight repeats over its expert's
  virtual experts elementwise (``repeat_interleave``);
- the dispatch and combine tensors are cast to the activations' dtype;
- ``N % g != 0`` raises.

On a mesh (x a DTensor) the MoE runs expert parallel by hand
(``_apply_moe_mesh``): every rank routes all tokens as one process does,
runs the experts it holds and adds its partial output into x's layout.

The products stay ``torch.einsum``, as the reference's are ``jnp.einsum``
outside any Pallas kernel (the dense MLP's are plain products too,
``models/layers.py::apply_mlp``). ``MoE`` is the ``nn.Module`` a block
holds, with the parameters ``router``, ``w_gate``, ``w_up`` and
``w_down``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dtype_of, init_dense, is_dtensor

__all__ = ["MoE", "init_moe", "split_moe_params", "route", "apply_moe", "moe_oracle", "capacity"]

_NAMES = ("router", "w_gate", "w_up", "w_down")


def _draws(generator: torch.Generator | None, cfg: ArchConfig):
    """The MoE's weights in the order they are drawn: (name, expert index or
    None for the router, tensor). With ``moe_split`` > 1 the experts are
    (E·split) virtual experts of ff/split columns."""
    dt = dtype_of(cfg)
    n_experts, d, ff, sp = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.moe_split
    if ff % sp:
        raise ValueError(f"{cfg.name}: d_ff {ff} does not split into moe_split {sp} slices")
    ev, ffv = n_experts * sp, ff // sp
    yield "router", None, init_dense(generator, d, n_experts, torch.float32)
    for name, din, dout, scale in (("w_gate", d, ffv, None), ("w_up", d, ffv, None),
                                   ("w_down", ffv, d, 0.02 / (2 * cfg.n_layers) ** 0.5)):
        for e in range(ev):
            yield name, e, init_dense(generator, din, dout, dt, scale)


def init_moe(generator: torch.Generator | None, cfg: ArchConfig) -> dict:
    """Expert weights; with ``moe_split`` > 1 they are stored pre-sliced as
    (E·split, d, ff/split) virtual experts (see :func:`split_moe_params`).
    Without a generator the tensors are on the meta device."""
    p, experts = {}, {}
    for name, e, w in _draws(generator, cfg):
        if e is None:
            p[name] = w
        else:
            experts.setdefault(name, []).append(w)
    return {**p, **{name: torch.stack(ws) for name, ws in experts.items()}}


def split_moe_params(p: dict, split: int) -> dict:
    """Re-slice unsplit expert params (E, d, ff) -> (E·split, d, ff/split).

    Virtual experts [e·split, e·split + split) are the ff-slices of real
    expert e; SwiGLU is elementwise over ff and w_down sums over ff, so the
    slices' outputs add up to the unsplit output."""
    n_experts, d, ff = p["w_gate"].shape
    ffv = ff // split

    def col(w):  # (E, d, ff) -> (E*split, d, ffv)
        return w.reshape(n_experts, d, split, ffv).transpose(1, 2).reshape(
            n_experts * split, d, ffv)

    def row(w):  # (E, ff, d) -> (E*split, ffv, d)
        return w.reshape(n_experts * split, ffv, d)

    return {"router": p["router"], "w_gate": col(p["w_gate"]), "w_up": col(p["w_up"]),
            "w_down": row(p["w_down"])}


def _route(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """logits (N, E) -> combine weights (N, E), the top k renormalized."""
    weights = torch.softmax(logits.float(), dim=-1)
    thresh = torch.topk(weights, top_k, dim=-1).values[..., -1:]
    w = torch.where(weights >= thresh, weights, 0.0)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)


def capacity(cfg: ArchConfig, group: int) -> int:
    """Slots per expert and group: Python's ``round``, halves to even."""
    return max(1, int(round(cfg.top_k * group * cfg.capacity_factor / cfg.n_experts)))


def _groups(cfg: ArchConfig, n: int) -> tuple[int, int]:
    g = min(cfg.moe_group_size, n)
    if n % g:
        raise ValueError(
            f"{cfg.name}: MoE dispatch needs the B*T = {n} tokens to split into groups of "
            f"g = {g} (moe_group_size), and {n} % {g} = {n % g}")
    return n // g, g


def route(p, cfg: ArchConfig, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The dispatch of x (B, T, d) -> (combine weights (G, g, E[v]) f32, keep
    (G, g, E[v]) bool, pos (G, g, E[v]): each token's slot in its expert's
    buffer, counted over the group's tokens that selected the expert)."""
    d = x.shape[-1]
    n_groups, g = _groups(cfg, x.shape[0] * x.shape[1])
    logits = x.reshape(n_groups, g, d).float() @ p["router"]  # (G, g, E)
    combine_w = _route(logits.reshape(-1, cfg.n_experts), cfg.top_k).reshape(n_groups, g, -1)
    if cfg.moe_split > 1:
        # Virtual ff-slice experts: a selected token goes to every slice of
        # its expert with the same combine weight (the slices' outputs add).
        combine_w = combine_w.repeat_interleave(cfg.moe_split, dim=-1)
    sel = combine_w > 0
    pos = torch.cumsum(sel.to(torch.int32), dim=1) - 1
    keep = sel & (pos < capacity(cfg, g))
    return combine_w, keep, pos


def _experts(p, cfg: ArchConfig, x: torch.Tensor, combine_w, keep, pos) -> torch.Tensor:
    """Dispatch, the expert products and the combine of x (B, T, d) over the
    experts (or d_ff slices) that ``p`` holds, given their columns of
    ``route``'s outputs."""
    b, t, d = x.shape
    n_groups, g, _ = keep.shape
    cap = capacity(cfg, g)
    # dispatch (G, g, E, cap): one-hot over the capacity slot.
    disp = keep[..., None] & (pos[..., None] == torch.arange(cap, device=x.device))
    disp_f = disp.to(x.dtype)
    comb_f = (combine_w[..., None] * disp).to(x.dtype)
    xin = torch.einsum("gsec,gsd->gecd", disp_f, x.reshape(n_groups, g, d))  # (G, E, cap, d)
    h = F.silu(torch.einsum("gecd,edf->gecf", xin, p["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", xin, p["w_up"])
    out = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    y = torch.einsum("gsec,gecd->gsd", comb_f, out)
    return y.reshape(b, t, d)


def apply_moe(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, d) -> (B, T, d)."""
    if is_dtensor(x):
        return _apply_moe_mesh(p, cfg, x)
    return _experts(p, cfg, x, *route(p, cfg, x))


def _apply_moe_mesh(p, cfg: ArchConfig, x) -> torch.Tensor:
    """``apply_moe`` of a DTensor x, expert parallel: x is gathered whole on
    every rank and routed there as one process routes it (every group of
    the B·T tokens, its slot positions and its capacity cut, whatever ranks
    the group's tokens came from); each rank runs the experts, or the d_ff
    slices, it holds (``param_pspecs``: experts over the model axis where
    they divide it) on their tokens; the outputs, and the gradients of x
    and the router, are partial sums over the mesh dims that split the
    experts, reduced into x's layout."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = x.device_mesh
    w = p["w_gate"]
    pl = w.placements if is_dtensor(w) else (Replicate(),) * mesh.ndim
    partial = tuple(Replicate() if q.is_replicate() else Partial() for q in pl)
    whole = (Replicate(),) * mesh.ndim

    def gathered(t):
        return t.redistribute(mesh, whole).to_local(grad_placements=partial)

    def local(t):
        return t.to_local() if is_dtensor(t) else t

    xf = gathered(x)
    router = p["router"]
    combine_w, keep, pos = route({"router": gathered(router) if is_dtensor(router) else router},
                                 cfg, xf)
    held = {name: local(p[name]) for name in ("w_gate", "w_up", "w_down")}
    n_held = held["w_gate"].shape[0]
    if n_held < combine_w.shape[-1]:  # experts split over the mesh: this rank's run
        index = 0
        for i, q in enumerate(pl):
            if q.is_shard() and q.dim == 0:
                index = index * mesh.size(i) + mesh.get_local_rank(i)
        cols = slice(index * n_held, (index + 1) * n_held)
        combine_w, keep, pos = combine_w[..., cols], keep[..., cols], pos[..., cols]
    y = _experts(held, cfg, xf, combine_w, keep, pos)
    # Into x's layout; where x is a partial sum over a mesh dim the experts
    # do not split (a decode step's single row), y is whole there already.
    out = tuple(Replicate() if p.is_partial() and q.is_replicate() else p
                for p, q in zip(x.placements, partial, strict=True))
    return DTensor.from_local(y, mesh, partial, run_check=False).redistribute(mesh, out)


def moe_oracle(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Per-token dense oracle (no capacity drops) for tests."""
    b, t, d = x.shape
    xf = x.reshape(-1, d)
    w = _route(xf.float() @ p["router"], cfg.top_k)  # (N, E)
    y = 0
    for e in range(cfg.n_experts):
        h = F.silu(xf @ p["w_gate"][e]) * (xf @ p["w_up"][e])
        y = y + w[:, e : e + 1].to(x.dtype) * (h @ p["w_down"][e])
    return y.reshape(b, t, d)


class MoE(nn.Module):
    """The MoE FFN of an ``attn_moe`` block: ``apply_moe`` over its own
    parameters (``router`` f32, the experts' weights in the config's dtype),
    created uninitialised on ``device``."""

    def __init__(self, cfg: ArchConfig, device) -> None:
        super().__init__()
        self.cfg = cfg
        for name, t in init_moe(None, cfg).items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(t.shape, dtype=t.dtype, device=device)))

    def params(self) -> dict:
        return {name: getattr(self, name) for name in _NAMES}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``init_moe``'s draws, each expert's copied into its slot as it is
        drawn: no stacked copy of the experts is made (at full width a
        layer's are tens of GB)."""
        for name, e, value in _draws(generator, self.cfg):
            (getattr(self, name) if e is None else getattr(self, name)[e]).copy_(value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_moe(self.params(), self.cfg, x)
