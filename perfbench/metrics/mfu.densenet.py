"""The whole model's FLOPs over the window at the TF32 peak (DenseNet
offline cell)."""
from perfbench.harness.readers import mfu as read  # noqa: F401
