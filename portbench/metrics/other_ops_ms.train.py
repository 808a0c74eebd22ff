"""Device ms a train step spends in kernels of no named family: train-mode
BatchNorm's passes and backward, casts, cat, pool and the loss terms."""
from portbench import trace
from portbench.readers import family_ms


def read(run):
    return family_ms(run, trace.OTHER, trace.TRAIN_FAMILIES)
