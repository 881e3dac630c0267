# The Mirovia/Altis benchmarks ported so far. Importing this package
# registers each with repro_torch.core.registry (Table I):
#   level 0 — MaxFlops (bf16, f32)
#   level 1 — GEMM (f32/bf16 x nn/tn)
#   level 2 — the DNN section's Connected and Softmax layers

from repro_torch.bench.level0 import maxflops  # noqa: F401
from repro_torch.bench.level1 import gemm  # noqa: F401
from repro_torch.bench.dnn import connected, softmax  # noqa: F401
