"""Level 2: LavaMD — N-body particle potentials within a cutoff (chemistry).

Counterpart of ``repro/bench/level2/lavamd.py``. Space is a 3-D lattice of
unit boxes; each home box interacts with itself and its 26 neighbours
through a static (boxes, 27) index table, out-of-lattice neighbours
pointing at a ghost box of zero-charge particles at infinity. The pair term
is the Rodinia DP-potential form u(r²) = exp(−2αr²)·q_i·q_j within the
cutoff, self-pairs excluded.

The reference ``vmap``s a (P, 27P) pair block over every box at once: at
preset 4 (26³ boxes of 80 particles) that is 3.0e9 pairs, 36 GB for the
displacements alone. Here the boxes go in chunks whose pair blocks stay
near :data:`CHUNK_BYTES`; each box's sum is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register

ALPHA = 0.5
CHUNK_BYTES = 1 << 30  # one f32 (boxes, P, 27P) block of a chunk
SAMPLE = 64  # home particles the brute-force check takes above its size limit


def neighbour_table(nb: int) -> np.ndarray:
    """(nb³, 27) box indices; out-of-lattice neighbours point at the ghost
    box nb³, so boundary boxes have fewer live neighbours."""
    idx = np.arange(nb**3).reshape(nb, nb, nb)
    padded = np.full((nb + 2, nb + 2, nb + 2), nb**3, dtype=np.int32)
    padded[1:-1, 1:-1, 1:-1] = idx
    out = np.empty((nb, nb, nb, 27), dtype=np.int32)
    n = 0
    for dx in (0, 1, 2):
        for dy in (0, 1, 2):
            for dz in (0, 1, 2):
                out[..., n] = padded[dx : dx + nb, dy : dy + nb, dz : dz + nb]
                n += 1
    return out.reshape(-1, 27)


def box_potentials(pos: torch.Tensor, charge: torch.Tensor, neigh: torch.Tensor,
                   cutoff2: float) -> torch.Tensor:
    """pos (B, P, 3), charge (B, P), neigh (B, 27) -> potential (B, P)."""
    boxes, ppb = charge.shape
    pos = torch.cat([pos, torch.full((1, ppb, 3), 1e6, dtype=pos.dtype, device=pos.device)])
    charge = torch.cat([charge, torch.zeros((1, ppb), dtype=charge.dtype, device=charge.device)])
    chunk = max(1, CHUNK_BYTES // (ppb * 27 * ppb * 4))
    out = []
    for b0 in range(0, boxes, chunk):
        nbr = neigh[b0 : b0 + chunk]
        home_pos, home_q = pos[b0 : b0 + nbr.shape[0]], charge[b0 : b0 + nbr.shape[0]]
        nb_pos = pos[nbr].reshape(nbr.shape[0], 27 * ppb, 3)
        nb_q = charge[nbr].reshape(nbr.shape[0], 27 * ppb)
        r2 = None
        for axis in range(3):
            d = home_pos[:, :, None, axis] - nb_pos[:, None, :, axis]  # (C, P, 27P)
            r2 = d * d if r2 is None else r2 + d * d
        u = torch.exp(-2.0 * ALPHA * r2) * home_q[:, :, None] * nb_q[:, None, :]
        u = torch.where((r2 <= cutoff2) & (r2 > 0.0), u, 0.0)  # exclude self
        out.append(torch.sum(u, dim=2))
    return torch.cat(out)


def brute_force_oracle(pos: np.ndarray, charge: np.ndarray, cutoff2: float,
                       rows: np.ndarray | None = None) -> np.ndarray:
    """All-pairs potentials in numpy, of the flattened particles ``rows``
    (all of them by default) against every particle."""
    flat_p = pos.reshape(-1, 3)
    flat_q = charge.reshape(-1)
    rows = np.arange(flat_q.size) if rows is None else rows
    d = flat_p[rows, None] - flat_p[None]
    r2 = (d * d).sum(-1)
    u = np.exp(-2.0 * ALPHA * r2) * flat_q[rows, None] * flat_q[None]
    u[(r2 > cutoff2) | (r2 <= 0.0)] = 0.0
    return u.sum(1)


def _make(nb: int, ppb: int) -> Workload:
    cutoff2 = 1.0  # box edge is 1.0: the neighbours cover the cutoff sphere
    table = torch.from_numpy(neighbour_table(nb))
    tables: dict[torch.device, torch.Tensor] = {}  # the table on each device used

    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        boxes = nb**3
        # Particles uniformly inside their own unit box (the reference's draws).
        corner = np.stack(
            np.meshgrid(*([np.arange(nb)] * 3), indexing="ij"), axis=-1
        ).reshape(-1, 1, 3)
        pos = corner + rng.uniform(0, 1, (boxes, ppb, 3))
        q = rng.uniform(0.5, 1.0, (boxes, ppb))
        return (torch.from_numpy(pos.astype(np.float32)), torch.from_numpy(q.astype(np.float32)))

    def fn(pos, charge):
        if pos.device not in tables:  # on the first call, outside timing
            tables[pos.device] = table.to(pos.device)
        return box_potentials(pos, charge, tables[pos.device], cutoff2)

    def validate(out, args):
        pos, charge = (a.cpu().numpy() for a in args)
        got = out.cpu().numpy().reshape(-1)
        rows = None
        if nb**3 * ppb > 4096:  # the reference's size limit for all pairs
            rows = np.random.default_rng(0).choice(got.size, SAMPLE, replace=False)
            got = got[rows]
        want = brute_force_oracle(pos, charge, cutoff2, rows)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    boxes = nb**3
    pair_flops = 11.0
    return Workload(
        name=f"lavamd.nb{nb}.ppb{ppb}",
        fn=fn,
        make_inputs=make_inputs,
        flops=boxes * ppb * 27 * ppb * pair_flops,
        bytes_moved=float(boxes * ppb * 16 * 27),
        validate=validate,
        # Opt out, as the reference: every box gathers its 27 neighbours.
        batch_dims=None,
    )


register(
    BenchmarkSpec(
        name="lavamd",
        level=2,
        dwarf="N-body",
        domain="Computational chemistry",
        cuda_feature=None,
        gpu_feature="dense neighbour-block pair terms, boxes in chunks",
        presets=geometric_presets(
            {"nb": 4, "ppb": 16}, scale_keys={"nb": 1.6, "ppb": 1.5}, round_to=2
        ),
        build=lambda nb, ppb: _make(nb, ppb),
    )
)
