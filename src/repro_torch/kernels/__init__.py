# Hand-written Hopper kernels (csrc/*.cu, built on first use by _build.py),
# each beside its plain PyTorch version, plus the dispatch layer (ops.py).
