# The Mirovia/Altis benchmarks ported so far. Importing this package
# registers each with repro_torch.core.registry (Table I):
#   level 0 — MaxFlops (bf16, f32)
#   level 1 — GEMM (f32/bf16 x nn/tn), Sort
#   level 2 — SRAD, Where, and the DNN section: Activation, Batchnorm,
#             Connected, Convolution (xla, im2col), Dropout, LRN, Pooling,
#             RNN and Softmax

from repro_torch.bench.level0 import maxflops  # noqa: F401
from repro_torch.bench.level1 import gemm, sort  # noqa: F401
from repro_torch.bench.level2 import srad, where  # noqa: F401
from repro_torch.bench.dnn import (  # noqa: F401
    activation,
    batchnorm,
    connected,
    convolution,
    dropout,
    lrn,
    pooling,
    rnn,
    softmax,
)
