"""Device ms a train step spends in the fused train-mode BatchNorm's kernels
(``csrc/batchnorm_train.cu``, names starting ``batchnorm_train_``); None
where the trace holds none of them (a program without that kernel family)."""
from portbench.readers import family_ms

KEY = "batchnorm_train_"
FAMILIES = (("fused train-mode BatchNorm", (KEY,)),)


def read(run):
    if run.trace is None or not run.trace.kernels(KEY):
        return None
    return family_ms(run, FAMILIES[0][0], FAMILIES)
