# Training runtime: the train/eval step factory (runtime/steps.py), sharding
# rules and placement over a DeviceMesh (runtime/sharding.py), elastic
# re-mesh arithmetic and meshes (runtime/elastic.py) and straggler
# monitoring (runtime/straggler.py); counterparts of repro/runtime/. The
# pod-axis pipeline is ROADMAP.md queue 1, item 16.6.

from repro_torch.runtime.elastic import build_mesh, choose_submesh, plan_remesh  # noqa: F401
from repro_torch.runtime.sharding import (  # noqa: F401
    ShardingRules,
    batch_pspec,
    cache_pspecs,
    data_mesh,
    host_data_mesh,
    init_distributed,
    make_activation_sharder,
    param_pspecs,
    place_args,
    placements,
    replicate,
    shard_applies,
    workload_pspecs,
    zero_pspecs,
)
from repro_torch.runtime.steps import make_eval_step, make_train_step  # noqa: F401
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
