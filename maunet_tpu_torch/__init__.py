"""maunet-tpu on PyTorch and CUDA: the serving, training and evaluation
paths of the U-Net and U-Net++ and the research command line (``cli.py``:
HPO studies, benchmark suites, sensitivity sweeps), ported from the JAX
package ``maunet_tpu`` to one NVIDIA H100 (Hopper, sm_90a).

The package imports ``torch`` and numpy, never JAX or ``maunet_tpu``.  Its
hand-written kernels live in ``csrc/`` and build at first use
(``ops/kernels/_build.py``); on CPU tensors every kernel wrapper runs its
plain PyTorch version instead.
"""
