"""The port's examples, counterparts of the repository's ``examples/``: each
runs as ``python -m repro_torch.examples.<name>`` with the reference's
defaults, flags and printed lines, plus ``--device {cuda,cpu}`` (``cuda``
unless the caller asks for the CPU; without a card a ``cuda`` run exits 2).

- ``quickstart``: a suite slice, a small LM trained, then served;
- ``run_suite``: the suite through the staged engine, as a table;
- ``serve_lm``: batched serving of an LM's smoke config (mixtral's);
- ``train_lm``: the end-to-end training driver, checkpoints and resume;
- ``feature_analysis``: the paper's four §V-B feature studies.
"""
