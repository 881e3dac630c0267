# The LM stack's dense part: ArchConfig (models/config.py), the layers
# (models/layers.py) and the Model (models/model.py), counterparts of
# repro/models/ for the attn_mlp block kind.

from repro_torch.models.config import ArchConfig  # noqa: F401
from repro_torch.models.model import Model  # noqa: F401
