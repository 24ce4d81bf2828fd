"""Launch scripts and their process-level helpers: ``launch/serve.py`` (the
serving command line, ``python -m repro_torch.launch.serve``) and
``launch/cpu.py`` (worker pinning, the serving env preset, the device
check)."""
