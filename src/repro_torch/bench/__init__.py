# The Mirovia/Altis benchmark suite, ported. Importing this package
# registers every benchmark with repro_torch.core.registry (Table I):
#   level 0 — device microbenchmarks (BusSpeed*, DeviceMemory, MaxFlops)
#   level 1 — basic parallel algorithms (GUPS, BFS, GEMM, Pathfinder, Sort)
#   level 2 — application kernels (CFD, DWT2D, KMeans, LavaMD, Mandelbrot,
#             NW, ParticleFilter, SRAD, Where) and the DNN section
#             (Activation, Batchnorm, Connected, Convolution, Dropout, LRN,
#             Pooling, RNN, Softmax)

from repro_torch.bench.level0 import devicemem, hostbus, maxflops  # noqa: F401
from repro_torch.bench.level1 import bfs, gemm, gups, pathfinder, sort  # noqa: F401
from repro_torch.bench.level2 import (  # noqa: F401
    cfd,
    dwt2d,
    kmeans,
    lavamd,
    mandelbrot,
    nw,
    particlefilter,
    srad,
    where,
)
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
