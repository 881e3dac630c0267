# Optimizer substrate: AdamW with a configurable moment dtype, the
# warmup-cosine schedule and global-norm clipping; counterparts of
# repro/optim/{adamw,schedule,clip}.py.

from repro_torch.optim.adamw import AdamW, AdamWState  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm, global_norm  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401


class ErrorFeedbackInt8:
    """Not ported: the reference's int8 error-feedback compression
    (``repro/optim/compression.py``) reduces over the pod axis with a
    collective, which waits for placement over several GPUs."""

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "ErrorFeedbackInt8 reduces gradients across devices (a psum and an "
            "all_gather over the pod axis); it is ROADMAP.md queue 1, item 12"
        )
