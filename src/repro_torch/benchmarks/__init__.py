"""Per-section benchmark scripts of the port (counterpart of the repository's
``benchmarks/``): ``python -m repro_torch.benchmarks.run``. So far the
paper's four §V-B feature studies (``feat_*``)."""
