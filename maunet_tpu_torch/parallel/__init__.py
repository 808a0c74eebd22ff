"""Parallelism over ranks and devices: ``multihost`` (the process group, its
data x spatial grid and each rank's rows), ``mesh`` (the devices of a mesh,
the training axes and the spatial guard), ``spatial`` (each image's rows
sharded over ranks, with halo exchanges) and ``infer`` (a batch split over a
mesh's devices in one process).  Ports of ``maunet_tpu/parallel/``."""
