"""Calls a train step makes of the fused train-mode BatchNorm
(``ops/kernels/batchnorm_train.py`` ``bn_relu_train``'s ``kernel_calls``
tally): 18 for the U-Net, one a train-mode BN; None on a program without
that tally."""
from portbench.program import tally_per_unit


def read(run):
    return tally_per_unit(run, "bn_relu_train.kernel_calls")
