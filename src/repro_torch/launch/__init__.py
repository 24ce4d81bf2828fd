"""Process- and thread-level launch helpers (``launch/cpu.py``: worker
pinning for the serving threads)."""
