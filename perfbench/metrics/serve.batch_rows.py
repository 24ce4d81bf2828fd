"""Real rows per executed batch over the window (ServingStats counters)."""
from perfbench.harness.readers import serve_batch_rows as read  # noqa: F401
