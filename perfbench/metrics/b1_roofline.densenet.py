"""B1's share of its roofline over the traced span (DenseNet offline cell):
the ideal time of the network's convs over the card's time in these
kernels."""
from perfbench.harness.readers import roofline

KERNELS = ("conv_sm90_kernel",)


def read(run):
    return roofline(run, KERNELS)
