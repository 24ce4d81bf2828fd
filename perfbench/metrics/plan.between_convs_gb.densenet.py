"""GB a batch that the plan moves between the convs: relayouts, standalone
BN and ReLU, concat seeds (DenseNet offline cell)."""
from perfbench.harness.between_convs import plan_gb as read  # noqa: F401
