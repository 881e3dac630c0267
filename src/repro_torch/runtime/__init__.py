# Training runtime: the train/eval step factory (runtime/steps.py), sharding
# rules and placement over a DeviceMesh (runtime/sharding.py), elastic
# re-mesh arithmetic and meshes (runtime/elastic.py) and straggler
# monitoring (runtime/straggler.py) and the pod-axis GPipe pipeline
# (runtime/pipeline.py); counterparts of repro/runtime/. The model axis runs
# (tensor, sequence and expert parallel, item 16.6 (i)), and so does the
# pod-axis pipeline, forward and backward (item 16.6 (ii)).

from repro_torch.runtime.elastic import (  # noqa: F401
    build_mesh,
    build_pod_mesh,
    choose_submesh,
    plan_remesh,
)
from repro_torch.runtime.pipeline import gpipe_forward, stacked_blocks  # noqa: F401
from repro_torch.runtime.pipeline import gpipe_forward, stacked_blocks  # noqa: F401
from repro_torch.runtime.sharding import (  # noqa: F401
    ShardingRules,
    batch_pspec,
    cache_pspecs,
    data_mesh,
    device_put,
    host_data_mesh,
    init_distributed,
    make_activation_sharder,
    named,
    param_pspecs,
    place_args,
    place_params,
    placements,
    replicate,
    shard_applies,
    workload_pspecs,
    zero_pspecs,
)
from repro_torch.runtime.steps import make_eval_step, make_train_step  # noqa: F401
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
