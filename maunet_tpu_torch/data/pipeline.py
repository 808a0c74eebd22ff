"""Host -> device input pipeline.

Takes the place of ``maunet_tpu/data/pipeline.py::prefetch_to_device``: a
worker thread decodes the ``.npz`` batches ahead of the consumer and pins
them in page-locked host memory; the consumer's thread issues the
``non_blocking`` copies on its current stream, so each copy is ordered
before the compute that reads it and overlaps the host's work on the next
step.  On the CPU the arrays become tensors without a copy.  Under data
parallelism each rank runs its own pipeline over its own rows of every
global batch (``make_batches``' ``sample_slice``) into its own device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from maunet_tpu_torch.data.dataset import Batch


def host_tensors(batch: Batch, pin: bool) -> dict[str, torch.Tensor]:
    """A batch's arrays as CPU tensors, page-locked when ``pin``."""
    out = {}
    for k, v in batch.as_dict().items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory() if pin else t
    return out


def to_device(arrays: dict[str, torch.Tensor], device: torch.device) -> dict[str, torch.Tensor]:
    return {k: v.to(device, non_blocking=True) for k, v in arrays.items()}


# Batches decoded ahead of the consumer (the JAX loop's buffer_size).
_AHEAD = 2


def prefetch_to_device(batches: Iterator[Batch],
                       device: torch.device) -> Iterator[dict[str, torch.Tensor]]:
    """Yield the batches as dicts of tensors on ``device``, decoded (and
    pinned, for a CUDA device) up to ``_AHEAD`` batches ahead.

    If the consumer abandons the generator, the worker stops at its next
    put instead of staying blocked on a full queue."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=_AHEAD)
    sentinel = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in batches:
                if not put(host_tensors(batch, pin)):
                    return
        except BaseException as e:  # re-raised in the consumer
            err.append(e)
        finally:
            put(sentinel)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield to_device(item, device)
    finally:
        stop.set()
        thread.join()
