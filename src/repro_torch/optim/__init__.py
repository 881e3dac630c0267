# Optimizer substrate: AdamW with a configurable moment dtype, the
# warmup-cosine schedule, global-norm clipping and int8 error-feedback
# gradient compression; counterparts of
# repro/optim/{adamw,schedule,clip,compression}.py.

from repro_torch.optim.adamw import AdamW, AdamWState  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm, global_norm  # noqa: F401
from repro_torch.optim.compression import ErrorFeedbackInt8  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
