"""Host ms a predict takes to enqueue its work (DenseNet offline cell)."""
from perfbench.harness.readers import host_enqueue_ms as read  # noqa: F401
