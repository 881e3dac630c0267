"""Tools of the port, counterparts of the repository's ``tools/``:
``python -m repro_torch.tools.render_experiments`` renders the dry run's
tables."""
