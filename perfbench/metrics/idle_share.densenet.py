"""The device's idle share of the traced span (DenseNet offline cell)."""
from perfbench.harness.readers import idle_share as read  # noqa: F401
