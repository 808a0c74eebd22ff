"""Data parallelism: ``multihost`` (the process group and each rank's rows),
``mesh`` (the devices of a mesh and the training data axis) and ``infer``
(a batch split over a mesh's devices in one process).  Ports of
``maunet_tpu/parallel/``; the spatial axis is not ported."""
