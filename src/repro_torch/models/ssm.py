"""Recurrent mixers: Mamba (S6) and the xLSTM pair (mLSTM / sLSTM).

Counterpart of ``repro/models/ssm.py``, function for function, on tensors
in the functional style of ``models/layers.py``: ``init_*(generator, cfg)``
builds a dict of tensors (meta tensors without a generator) with the
reference's shapes and dtypes, and the apply functions take such a dict
(or an ``nn.ParameterDict``).

The projections run over the whole sequence at once; the recurrence is a
Python loop over time, one step at a time in the reference's order, with
f32 state, where the reference runs a ``lax.scan``. The chunked mLSTM
loops over chunks and runs each chunk's body vectorised. No kernel is
launched: the reference's scans are ``lax.scan`` and ``jnp`` products
outside any Pallas kernel, and the port's are torch operations.

The reference's arithmetic, kept exactly:

- Mamba's ``A_log``, ``D`` and ``dt_b``, the mLSTM's ``w_gates`` and
  ``b_gates``, the sLSTM's recurrent matrices and bias are f32 in a bf16
  model; ``delta``, B and C are f32 in the recurrence, and y is cast back
  to the model's dtype before the gate;
- the causal conv of a full sequence sums its taps' products in the
  model's dtype, in tap order; a decode step computes its conv in f32 and
  casts (so in bf16 prefill-then-decode is not bit-equal to a full
  forward, in the reference too);
- the group norm takes the population variance in f32, casts to the
  gain's dtype, then multiplies by the gain;
- the mLSTM's q and k come from the conv output, its v from the pre-conv
  input; its forget gate is taken in log space (``logsigmoid``);
- the chunked mLSTM runs only when ``xlstm_chunk`` divides T and T > L;
- the sLSTM's state starts with n = 1; its FFN is GELU's tanh form
  (``jax.nn.gelu``'s default);
- a prompt shorter than the conv's window pads its tail at the front.

Each mixer exposes ``init_*``, ``apply_*`` (full sequence -> (y,
final_state)), ``step_*`` (one decode step -> (y_t, state)) and
``init_state_*`` (zero state for decode, on the device the caller names).

On a mesh (DTensor activations and parameters) the projections run on
DTensors and each recurrence on each rank's batch rows as plain tensors
(``layers.on_rows``: the loop pays no DTensor dispatch a step, and its
parameters' gradients come back as partial sums over the data axes).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    dtype_of,
    init_dense,
    is_dtensor,
    merge_heads,
    on_rows,
    rms_norm,
    split_heads,
)

__all__ = [
    "init_mamba", "apply_mamba", "step_mamba", "init_state_mamba",
    "init_mlstm", "apply_mlstm", "step_mlstm", "init_state_mlstm",
    "init_slstm", "apply_slstm", "step_slstm", "init_state_slstm",
]


def _device(generator: torch.Generator | None):
    return "meta" if generator is None else generator.device


def _normal(generator: torch.Generator | None, shape, scale: float, dtype) -> torch.Tensor:
    """``scale`` times a standard normal, in ``dtype``."""
    w = torch.randn(shape, generator=generator, device=_device(generator))
    return (scale * w).to(dtype)


def _conv_tail(x: torch.Tensor, ck: int) -> torch.Tensor:
    """The last ck - 1 positions of x (B, T, C), a prompt shorter than that
    padded at the front: the decode conv's window. A copy, so that the cache
    does not hold the whole sequence."""
    t = x.shape[1]
    tail = x[:, -(ck - 1):] if t >= ck - 1 else F.pad(x, (0, 0, ck - 1 - t, 0))
    return tail.clone(memory_format=torch.contiguous_format)


def _conv_step(p, window: torch.Tensor, dtype) -> torch.Tensor:
    """A decode step's causal conv over ``window`` (B, ck, C), in f32, then
    SiLU, cast to ``dtype``."""
    conv = torch.einsum("bki,ki->bi", window.float(), p["conv_w"].float())
    return F.silu(conv + p["conv_b"].float()).to(dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``, elementwise on each rank's shard for a DTensor
    (DTensor has no rule for its backward)."""
    if not is_dtensor(x):
        return F.logsigmoid(x)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    x = x.redistribute(mesh, tuple(Replicate() if q.is_partial() else q for q in x.placements))
    return DTensor.from_local(F.logsigmoid(x.to_local()), mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


# ---------------------------------------------------------------------------
# Mamba (S6 selective SSM).
# ---------------------------------------------------------------------------


def init_mamba(generator: torch.Generator | None, cfg: ArchConfig) -> dict:
    dt = dtype_of(cfg)
    d, di, ds, dtr, ck = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    device = _device(generator)
    # S4/Mamba A initialization: A_i,s = -(s+1).
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=device)[None, :].repeat(di, 1)
    return {
        "in_proj": init_dense(generator, d, 2 * di, dt),
        "conv_w": _normal(generator, (ck, di), 0.1, dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "x_proj": init_dense(generator, di, dtr + 2 * ds, dt),
        "dt_w": init_dense(generator, dtr, di, dt),
        "dt_b": torch.full((di,), math.log(math.expm1(0.01)), dtype=torch.float32,
                           device=device),  # dt ~ 0.01
        "A_log": torch.log(a),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": init_dense(generator, di, d, dt, scale=0.02 / (2 * cfg.n_layers) ** 0.5),
    }


def _mamba_conv_full(p, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, C) -> its causal depthwise conv, the taps' products summed
    in x's dtype in tap order."""
    ck = p["conv_w"].shape[0]
    t = x.shape[1]
    xp = F.pad(x, (0, 0, ck - 1, 0))
    out = sum(xp[:, i:i + t] * p["conv_w"][i] for i in range(ck))
    return out + p["conv_b"]


def _mamba_scan_inputs(p, cfg: ArchConfig, xc: torch.Tensor):
    """xc (B, T, di) conv output -> (delta, Bt, Ct) for the recurrence, f32."""
    proj = xc @ p["x_proj"]  # (B, T, dtr + 2 ds)
    dtr, ds = cfg.dt_rank, cfg.ssm_state
    d_raw, bt, ct = torch.split(proj, [dtr, ds, ds], dim=-1)
    delta = _softplus((d_raw @ p["dt_w"]).float() + p["dt_b"])  # (B, T, di)
    return delta, bt.float(), ct.float()


def _mamba_step(p, h: torch.Tensor, inputs):
    """One recurrence step. h (B, di, ds) f32."""
    xc_t, delta_t, b_t, c_t = inputs  # (B, di) (B, di) (B, ds) (B, ds)
    a_mat = -torch.exp(p["A_log"])  # (di, ds)
    a = torch.exp(delta_t[:, :, None] * a_mat[None])  # (B, di, ds)
    b = delta_t[:, :, None] * b_t[:, None, :] * xc_t.float()[:, :, None]
    h = a * h + b
    y = (h @ c_t[:, :, None])[..., 0] + p["D"] * xc_t.float()  # h C, (B, di)
    return h, y


def init_state_mamba(cfg: ArchConfig, batch: int, device) -> dict:
    di, ds, ck = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "h": torch.zeros((batch, di, ds), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, ck - 1, di), dtype=dtype_of(cfg), device=device),
    }


def apply_mamba(p, cfg: ArchConfig, x: torch.Tensor):
    """x (B, T, d) -> (y (B, T, d), final_state)."""
    b, t, _ = x.shape
    x1, z = (x @ p["in_proj"]).chunk(2, dim=-1)  # (B, T, di)
    xc = F.silu(_mamba_conv_full(p, x1))
    delta, bt, ct = _mamba_scan_inputs(p, cfg, xc)

    def scan(q, xc, delta, bt, ct):
        h = torch.zeros((xc.shape[0], cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                        device=xc.device)
        ys = []
        for i in range(t):
            h, y = _mamba_step(q, h, (xc[:, i], delta[:, i], bt[:, i], ct[:, i]))
            ys.append(y)
        return torch.stack(ys, dim=1), h

    y, h = on_rows(scan, (xc, delta, bt, ct), {"A_log": p["A_log"], "D": p["D"]})
    y = y.to(x.dtype)  # (B, T, di)
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, {"h": h, "conv": _conv_tail(x1, cfg.ssm_conv)}


def step_mamba(p, cfg: ArchConfig, x_t: torch.Tensor, state: dict):
    """x_t (B, d), state from init_state/prefill -> (y_t (B, d), state)."""
    x1, z = (x_t @ p["in_proj"]).chunk(2, dim=-1)  # (B, di)
    window = torch.cat([state["conv"], x1[:, None, :]], dim=1)  # (B, ck, di)
    xc = _conv_step(p, window, x_t.dtype)
    proj = xc @ p["x_proj"]
    dtr, ds = cfg.dt_rank, cfg.ssm_state
    d_raw, b_t, c_t = torch.split(proj, [dtr, ds, ds], dim=-1)
    delta = _softplus((d_raw @ p["dt_w"]).float() + p["dt_b"])
    h, y = on_rows(lambda q, h, *inputs: _mamba_step(q, h, inputs),
                    (state["h"], xc, delta, b_t.float(), c_t.float()),
                    {"A_log": p["A_log"], "D": p["D"]})
    out = (y.to(x_t.dtype) * F.silu(z)) @ p["out_proj"]
    return out, {"h": h, "conv": window[:, 1:]}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block), self-contained, with a x2 up-projection.
# ---------------------------------------------------------------------------


def init_mlstm(generator: torch.Generator | None, cfg: ArchConfig) -> dict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    du = 2 * d
    heads = cfg.xlstm_heads
    device = _device(generator)
    return {
        "ln": torch.ones((d,), dtype=dt, device=device),
        "w_up": init_dense(generator, d, 2 * du, dt),
        "conv_w": _normal(generator, (cfg.ssm_conv, du), 0.1, dt),
        "conv_b": torch.zeros((du,), dtype=dt, device=device),
        "wq": init_dense(generator, du, du, dt),
        "wk": init_dense(generator, du, du, dt),
        "wv": init_dense(generator, du, du, dt),
        "w_gates": init_dense(generator, du, 2 * heads, torch.float32),
        "b_gates": torch.cat([  # forget bias high
            torch.zeros((heads,), device=device),
            torch.linspace(3.0, 6.0, heads, device=device)]),
        "gn": torch.ones((du,), dtype=dt, device=device),
        "w_down": init_dense(generator, du, d, dt, scale=0.02 / (2 * cfg.n_layers) ** 0.5),
    }


def _mlstm_step(C, n, m, q, k, v, i_raw, f_raw):
    """Stabilized exponential-gating matrix-memory update (xLSTM eq. 19-27).

    C (B,H,dk,dv), n (B,H,dk), m (B,H); q/k/v (B,H,dh); i_raw/f_raw (B,H).
    """
    m_new = torch.maximum(f_raw + m, i_raw)
    i = torch.exp(i_raw - m_new)
    f = torch.exp(f_raw + m - m_new)
    C = f[..., None, None] * C + i[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = f[..., None] * n + i[..., None] * k
    num = (q[..., None, :] @ C)[..., 0, :]  # C^T q, (B, H, dv)
    den = torch.clamp(torch.abs((n * q).sum(-1)), min=1.0)
    return C, n, m_new, num / den[..., None]


def init_state_mlstm(cfg: ArchConfig, batch: int, device) -> dict:
    du = 2 * cfg.d_model
    heads = cfg.xlstm_heads
    dh = du // heads
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, heads, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, heads, dh), dtype=f32, device=device),
        "m": torch.zeros((batch, heads), dtype=f32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, du), dtype=dtype_of(cfg), device=device),
    }


def _mlstm_parallel_inputs(p, cfg: ArchConfig, xm: torch.Tensor):
    """xm (B, T, du) -> per-step q, k, v, i, f (f32 gates), and the conv
    output."""
    heads = cfg.xlstm_heads
    b, t, du = xm.shape
    dh = du // heads
    xc = F.silu(_mamba_conv_full({"conv_w": p["conv_w"], "conv_b": p["conv_b"]}, xm))
    q = split_heads(xc @ p["wq"], heads, dh).float() * dh**-0.5
    k = split_heads(xc @ p["wk"], heads, dh).float() * dh**-0.5
    v = split_heads(xm @ p["wv"], heads, dh).float()
    gates = xc.float() @ p["w_gates"] + p["b_gates"]
    i_raw, f_raw = gates.chunk(2, dim=-1)  # (B, T, H)
    f_raw = _logsigmoid(f_raw)  # f = sigmoid in log space
    return q, k, v, i_raw, f_raw, xc


def _group_norm_heads(h: torch.Tensor, gamma: torch.Tensor, heads: int) -> torch.Tensor:
    """Per-head group normalization of (B, T, du) or (B, du): the population
    variance in f32, cast to the gain's dtype, times the gain."""
    shp = h.shape
    hh = h.reshape(*shp[:-1], heads, shp[-1] // heads).float()
    mu = hh.mean(-1, keepdim=True)
    var = hh.var(-1, keepdim=True, correction=0)
    out = (hh - mu) * torch.rsqrt(var + 1e-5)
    return merge_heads(out).to(gamma.dtype) * gamma


def _mlstm_chunk_body(carry, inp):
    """One chunk of the chunkwise-parallel stabilized mLSTM.

    With per-step log decays f and log inputs i, define within a chunk of
    length L

        B_j = sum_{r<=j} f_r,      a_k = i_k - B_k,
        M_j = max(m_prev, cummax_{k<=j} a_k)       (the running stabilizer),

    then the sequential recurrence is exactly

        h_j ~ e^{m_prev-M_j} C_prev q_j + sum_{k<=j} e^{a_k-M_j} (k_k.q_j) v_k,
        n_j = e^{m_prev-M_j} n_prev + sum_{k<=j} e^{a_k-M_j} k_k,
        C_new = e^{m_prev-M_L} C_prev + sum_k e^{a_k-M_L} k_k v_k^T,
        m_new = B_L + M_L.

    All exponents are <= 0 (stable), and the state is touched once a chunk.
    """
    C, n, m = carry
    q, k, v, i_raw, f_raw = inp  # (B, L, H, dh) / gates (B, L, H)
    b_cum = torch.cumsum(f_raw, dim=1)  # (B, L, H)
    a = i_raw - b_cum
    M = torch.maximum(m[:, None], torch.cummax(a, dim=1).values)  # (B, L, H)
    inter = torch.exp(m[:, None] - M)  # (B, L, H)

    # inter-chunk contribution from the carried state
    num = inter[..., None] * torch.einsum("bhkv,blhk->blhv", C, q)
    n_j = inter[..., None] * n[:, None]

    # intra-chunk attention-like block (causal within the chunk)
    s = torch.einsum("blhd,bmhd->bhlm", q, k)  # (B, H, L, L)
    w = torch.exp(a.movedim(-1, 1)[:, :, None, :] - M.movedim(-1, 1)[:, :, :, None])
    L = q.shape[1]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    w = torch.where(causal[None, None], w, 0.0)  # w[j, k] = e^{a_k - M_j}, k <= j
    num = num + torch.einsum("bhlm,bmhv->blhv", s * w, v)
    n_j = n_j + torch.einsum("bhlm,bmhd->blhd", w, k)

    den = torch.clamp(torch.abs(torch.einsum("blhd,blhd->blh", n_j, q)), min=1.0)
    h = num / den[..., None]

    # carry update (state touched once per chunk)
    scale_prev = torch.exp(m - M[:, -1])  # (B, H)
    w_last = torch.exp(a - M[:, -1][:, None])  # (B, L, H)
    C_new = scale_prev[..., None, None] * C + torch.einsum(
        "blhk,blhv->bhkv", w_last[..., None] * k, v)
    n_new = scale_prev[..., None] * n + torch.einsum("blh,blhd->bhd", w_last, k)
    m_new = b_cum[:, -1] + M[:, -1]
    return (C_new, n_new, m_new), h


def apply_mlstm(p, cfg: ArchConfig, x: torch.Tensor):
    """x (B, T, d) -> (x + the block's output, final_state): chunked when
    ``xlstm_chunk`` divides T and T > ``xlstm_chunk``, else sequential."""
    b, t, _ = x.shape
    heads = cfg.xlstm_heads
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    xm, z = (xn @ p["w_up"]).chunk(2, dim=-1)  # (B, T, du)
    q, k, v, i_raw, f_raw, _ = _mlstm_parallel_inputs(p, cfg, xm)
    du = xm.shape[-1]
    L = cfg.xlstm_chunk

    def scan(_, q, k, v, i_raw, f_raw):
        state = init_state_mlstm(cfg, q.shape[0], device=q.device)
        C, n, m = state["C"], state["n"], state["m"]
        hs = []
        if L and t % L == 0 and t > L:
            for c in range(t // L):
                sl = slice(c * L, (c + 1) * L)
                (C, n, m), h = _mlstm_chunk_body(
                    (C, n, m), (q[:, sl], k[:, sl], v[:, sl], i_raw[:, sl], f_raw[:, sl]))
                hs.append(h)
            return torch.cat(hs, dim=1), C, n, m
        for i in range(t):
            C, n, m, h = _mlstm_step(
                C, n, m, q[:, i], k[:, i], v[:, i], i_raw[:, i], f_raw[:, i])
            hs.append(h)
        return torch.stack(hs, dim=1), C, n, m

    h, C, n, m = on_rows(scan, (q, k, v, i_raw, f_raw))
    h = _group_norm_heads(h.reshape(b, t, du).to(x.dtype), p["gn"], heads)
    out = (h * F.silu(z)) @ p["w_down"]
    return x + out, {"C": C, "n": n, "m": m, "conv": _conv_tail(xm, cfg.ssm_conv)}


def step_mlstm(p, cfg: ArchConfig, x_t: torch.Tensor, state: dict):
    b, _ = x_t.shape
    heads = cfg.xlstm_heads
    xn = rms_norm(x_t, p["ln"], cfg.norm_eps)
    xm, z = (xn @ p["w_up"]).chunk(2, dim=-1)  # (B, du)
    du = xm.shape[-1]
    dh = du // heads
    window = torch.cat([state["conv"], xm[:, None, :]], dim=1)
    xc = _conv_step(p, window, x_t.dtype)
    q = split_heads(xc @ p["wq"], heads, dh).float() * dh**-0.5
    k = split_heads(xc @ p["wk"], heads, dh).float() * dh**-0.5
    v = split_heads(xm @ p["wv"], heads, dh).float()
    gates = xc.float() @ p["w_gates"] + p["b_gates"]
    i_raw, f_raw = gates.chunk(2, dim=-1)
    f_raw = _logsigmoid(f_raw)
    C, n, m, h = on_rows(lambda _, *args: _mlstm_step(*args),
                          (state["C"], state["n"], state["m"], q, k, v, i_raw, f_raw))
    h = _group_norm_heads(h.reshape(b, du).to(x_t.dtype), p["gn"], heads)
    out = (h * F.silu(z)) @ p["w_down"]
    return x_t + out, {"C": C, "n": n, "m": m, "conv": window[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory block with a per-head recurrence).
# ---------------------------------------------------------------------------


def init_slstm(generator: torch.Generator | None, cfg: ArchConfig) -> dict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    heads = cfg.xlstm_heads
    dh = d // heads
    device = _device(generator)
    # xLSTM's 4/3 post-up-projection, rounded up to a multiple of 128.
    dff = -(-(4 * d) // (3 * 128)) * 128

    def rec():  # block-diagonal per-head recurrent matrix
        return _normal(generator, (heads, dh, dh), 0.02, torch.float32)

    p = {"ln": torch.ones((d,), dtype=dt, device=device),
         "w_x": init_dense(generator, d, 4 * d, dt)}  # z, i, f, o stacked
    for gate in ("r_z", "r_i", "r_f", "r_o"):
        p[gate] = rec()
    p["b"] = torch.cat([torch.zeros((2 * d,), device=device),
                        torch.full((d,), 3.0, device=device),
                        torch.zeros((d,), device=device)])  # forget bias high
    p["gn"] = torch.ones((d,), dtype=dt, device=device)
    p["w_ff1"] = init_dense(generator, d, dff, dt)
    p["w_ff2"] = init_dense(generator, dff, d, dt, scale=0.02 / (2 * cfg.n_layers) ** 0.5)
    return p


def init_state_slstm(cfg: ArchConfig, batch: int, device) -> dict:
    d = cfg.d_model
    f32 = torch.float32
    return {
        "c": torch.zeros((batch, d), dtype=f32, device=device),
        "n": torch.ones((batch, d), dtype=f32, device=device),
        "m": torch.zeros((batch, d), dtype=f32, device=device),
        "h": torch.zeros((batch, d), dtype=f32, device=device),
    }


def _slstm_r(p) -> torch.Tensor:
    """[r_z r_i r_f r_o] (H, dh, 4 dh): the four block-diagonal recurrent
    matrices side by side, made once a call of ``apply_slstm`` or
    ``step_slstm``, not once a token."""
    return torch.cat([p["r_z"], p["r_i"], p["r_f"], p["r_o"]], dim=-1)


def _slstm_cell(r: torch.Tensor, cfg: ArchConfig, state: dict, x_proj: torch.Tensor):
    """x_proj (B, 4d) = x @ w_x + b; r = ``_slstm_r(p)``. Returns (state,
    h_out)."""
    heads = cfg.xlstm_heads
    d = cfg.d_model
    dh = d // heads
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    b = c.shape[0]
    # The four block-diagonal matvecs (z, i, f, o) as one batched product
    # over the heads: h (H, B, dh) @ r (H, dh, 4 dh), each output element
    # the same dh-long dot product as the reference's einsum.
    rec = torch.bmm(h.view(b, heads, dh).transpose(0, 1), r)  # (H, B, 4 dh)
    pre = x_proj.float().view(b, 4, heads, dh) + rec.view(heads, b, 4, dh).permute(1, 2, 0, 3)
    zx, ix, fx, ox = (g.reshape(b, d) for g in pre.unbind(1))  # each x + rmul(r, h)
    z = torch.tanh(zx)
    f_raw = F.logsigmoid(fx)
    o = torch.sigmoid(ox)
    m_new = torch.maximum(f_raw + m, ix)
    i = torch.exp(ix - m_new)
    f = torch.exp(f_raw + m - m_new)
    c = f * c + i * z
    n = f * n + i
    h_new = o * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h_new}, h_new


def _slstm_ffn(p, h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h @ p["w_ff1"], approximate="tanh") @ p["w_ff2"]


def apply_slstm(p, cfg: ArchConfig, x: torch.Tensor):
    b, t, _ = x.shape
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    xp = xn @ p["w_x"] + p["b"].to(xn.dtype)  # (B, T, 4d)

    def scan(q, xp):
        state = init_state_slstm(cfg, xp.shape[0], device=xp.device)
        hs = []
        for i in range(t):
            state, h = _slstm_cell(q["r"], cfg, state, xp[:, i])
            hs.append(h)
        return state, torch.stack(hs, dim=1)

    state, h = on_rows(scan, (xp,), {"r": _slstm_r(p)})
    h = h.to(x.dtype)  # (B, T, d)
    h = x + _group_norm_heads(h, p["gn"], cfg.xlstm_heads)
    return h + _slstm_ffn(p, h), state


def step_slstm(p, cfg: ArchConfig, x_t: torch.Tensor, state: dict):
    xn = rms_norm(x_t, p["ln"], cfg.norm_eps)
    xp = xn @ p["w_x"] + p["b"].to(xn.dtype)
    names = ("c", "n", "m", "h")
    state, h = on_rows(
        lambda q, xp, *st: _slstm_cell(q["r"], cfg, dict(zip(names, st, strict=True)), xp),
        (xp, *(state[k] for k in names)), {"r": _slstm_r(p)})
    h = x_t + _group_norm_heads(h.to(x_t.dtype), p["gn"], cfg.xlstm_heads)
    return h + _slstm_ffn(p, h), state
