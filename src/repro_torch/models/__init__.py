# The LM stack: ArchConfig (models/config.py), the layers (models/layers.py),
# the MoE FFN (models/moe.py), the recurrent mixers (models/ssm.py) and the
# Model (models/model.py), counterparts of repro/models/ for every block kind.

from repro_torch.models.config import ArchConfig  # noqa: F401
from repro_torch.models.model import Model  # noqa: F401
