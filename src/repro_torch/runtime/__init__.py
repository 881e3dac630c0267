# Training runtime: the train/eval step factory (runtime/steps.py), elastic
# re-mesh arithmetic (runtime/elastic.py) and straggler monitoring
# (runtime/straggler.py); counterparts of repro/runtime/. Sharding rules
# and the pod-axis pipeline are placement over several GPUs (ROADMAP.md
# queue 1, item 12).

from repro_torch.runtime.elastic import choose_submesh, plan_remesh  # noqa: F401
from repro_torch.runtime.steps import make_eval_step, make_train_step  # noqa: F401
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
