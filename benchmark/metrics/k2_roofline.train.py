"""K2's share of its roofline in the traced stretch: dQ's three products over the
causal triangle of each call ([batch, seq_len] of the mix, every head),
over the device time of its kernel, against the card's bf16 peak."""

from benchmark import roofline
from benchmark.readers import train_kernel_share
from benchmark.trace import K2


def read(run):
    return train_kernel_share(run, K2, roofline.flash_bwd_dq)
