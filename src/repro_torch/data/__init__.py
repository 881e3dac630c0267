# Data substrate: deterministic, stateless synthetic token streams (exactly
# resumable from a step index: a checkpoint stores only the cursor) and a
# host-to-device prefetch pipeline on a side CUDA stream; counterparts of
# repro/data/{synthetic,pipeline}.py.

from repro_torch.data.pipeline import Prefetch  # noqa: F401
from repro_torch.data.synthetic import SyntheticEmbeds, SyntheticLM  # noqa: F401
