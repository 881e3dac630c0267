"""Global-norm gradient clipping, f32 accumulation across the leaves
(counterpart of ``repro/optim/clip.py``).

The reference sums its leaves in JAX's pytree order (sorted keys, each block
leaf stacked over the layers); the port sums one tensor a layer, in the
order it is given. Both are f32 sums, so the norm differs only by the order
of the additions: a few f32 roundings, within 1e-6 relative.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import is_dtensor

__all__ = ["global_norm", "clip_by_global_norm"]


def _sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    s = torch.sum(torch.square(g.float()))
    # A DTensor leaf's sum is over the whole tensor (its shards' partial
    # sums reduced over the mesh), read back as a plain 0-d tensor.
    return s.full_tensor() if is_dtensor(s) else s


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (whole
    tensors, for DTensor leaves too)."""
    return torch.sqrt(sum(_sum_of_squares(g) for g in tree.values()))


def clip_by_global_norm(
    tree: dict[str, torch.Tensor], max_norm: float
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """(leaves scaled by min(1, max_norm / max(norm, 1e-9)) in f32 and cast
    back to their dtype, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in tree.items()}, norm
