"""The reference's three entry points under ``examples/``, as modules of
the port: ``python -m repro_torch.examples.quickstart``,
``.serve_planned_cnn`` and ``.train_lm_fault_tolerant``.  Each runs on
``--device`` (default ``cuda``; it raises without a card, and
``--device cpu`` runs the kernels' plain versions)."""
