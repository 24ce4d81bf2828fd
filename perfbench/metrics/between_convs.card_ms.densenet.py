"""The card's ms a batch in the work between the convs over the traced span
(DenseNet offline cell)."""
from perfbench.harness.between_convs import card_ms as read  # noqa: F401
