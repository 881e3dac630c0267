"""Per-section benchmark scripts of the port (counterpart of the repository's
``benchmarks/``): ``python -m repro_torch.benchmarks.run``. The paper's
tables and figures (Table I, Table II, Figs. 3, 4, 5 and 12, ``fig_impl``,
the roofline table's suite-report mode) and its four §V-B feature studies
(``feat_*``)."""
