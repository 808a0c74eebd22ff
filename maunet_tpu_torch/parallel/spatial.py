"""The spatial mesh axis: each image's rows sharded over ranks.

JAX shards the H axis of ``maps`` and ``targets`` over the mesh's
``spatial`` axis (``maunet_tpu/parallel/mesh.py`` ``batch_pspec(...,
shard_spatial=True)``), and XLA's partitioner inserts the halo exchanges.
Here they are written out.  The ranks of one data index
(``multihost.axes()``: ``spatial`` ranks, in spatial order) each hold an
equal band of every image's rows, and what reads across a band's edge
fetches the rows it needs from its neighbours first:

- every 3x3 conv extends its spatial parts by one row on each side that
  has a neighbour (two for the pair kernel), runs as on a whole map and
  keeps its own rows (``models/blocks.py``);
- the align-corners resizes compute their rows of the global resize from
  their own rows and one of each neighbour's (``ops/resize.py``);
- the gradient loss takes one row from below and the VALID 11x11 SSIM ten;
  every mean is a share of the global one (``losses/``).

Everything else is local: the 2x2 pools (the guard makes every band's
height even at every level), the 1x1 heads, and BatchNorm, whose statistics
are summed over every rank of the process group already
(``blocks.batch_norm_train``; on the card ``ops/kernels/batchnorm_train.py``).
The LSTM and the metadata MLP run whole on every rank of a data index.

:func:`row_shards` makes a :class:`SpatialContext` current; the train and
eval steps enter it (``train/steps.py``), and the model and the losses read
it through :func:`current`.  With one spatial rank nothing changes and
nothing is exchanged.  Rows move with ``all_gather`` over the spatial
group, which Gloo and NCCL both take for CUDA tensors; :func:`halo_rows`
is an autograd ``Function`` whose backward returns each halo row's gradient
to the rank that owns the row.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist

from maunet_tpu_torch.parallel.mesh import validate_spatial_sharding
from maunet_tpu_torch.parallel.multihost import axes


@dataclass(frozen=True)
class SpatialContext:
    """This rank's band of the current tiles: the spatial ``group`` of
    ``size`` ranks, the rank's ``index`` in it and the tiles' global
    ``height``.  Each level of the model has the same split: a band of h
    rows there is rows [index * h, (index + 1) * h) of h * size
    (:meth:`rows`)."""

    group: object
    size: int
    index: int
    height: int

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    def rows(self, h: int) -> tuple[int, int]:
        """(global height, first global row) of a band of ``h`` rows."""
        return h * self.size, self.index * h


_state = threading.local()


def current() -> SpatialContext | None:
    """The spatial context in force, or None (whole images)."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def row_shards(local_rows: int):
    """Within it, image tensors are this rank's band of ``local_rows`` rows
    of every tile, when the process group has a spatial axis
    (``multihost.axes().spatial > 1``); the tiles' height must pass
    :func:`~maunet_tpu_torch.parallel.mesh.validate_spatial_sharding`.
    Without a spatial axis it changes nothing."""
    grid = axes()
    if grid.spatial <= 1:
        yield None
        return
    height = local_rows * grid.spatial
    validate_spatial_sharding(height, grid.spatial)
    before = current()
    _state.ctx = SpatialContext(grid.spatial_group, grid.spatial, grid.spatial_index, height)
    try:
        yield _state.ctx
    finally:
        _state.ctx = before


def shard_rows(x, index: int | None = None, size: int | None = None):
    """Band ``index`` of ``size`` (by default this rank's, from
    ``multihost.axes()``) of ``x``'s axis 1, the rows of an NHWC batch:
    a tensor or a numpy array."""
    grid = axes()
    index = grid.spatial_index if index is None else index
    size = grid.spatial if size is None else size
    h = x.shape[1]
    if h % size:
        raise ValueError(f"{h} rows do not divide over {size} spatial ranks")
    n = h // size
    return x[:, index * n:(index + 1) * n]


def _all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole tiles from every rank's band (axis 1), on every rank of
    the spatial group; outside a spatial context, ``x``.  No gradient."""
    ctx = current()
    if ctx is None:
        return x
    return torch.cat(_all_gather(x.detach(), ctx.group), dim=1)


def sum_over_bands(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the spatial group (every rank gets the same
    bits); outside a spatial context, ``t``.  No gradient."""
    ctx = current()
    if ctx is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=ctx.group)
    return t


def share(value: float) -> float:
    """This rank's share of a constant term of a loss, so that the shares
    of the spatial group add up to ``value``."""
    ctx = current()
    return value if ctx is None else value / ctx.size


class _HaloRows(torch.autograd.Function):
    """Forward: ``x`` with ``up`` rows of the band above and ``down`` rows
    of the band below added on (none at a global edge).  Backward: the
    gradient of the own rows, plus the gradients that the neighbours'
    halos gathered for this band's edge rows."""

    @staticmethod
    def forward(ctx_fn, x, up: int, down: int, ctx: SpatialContext):
        h = x.shape[1]
        ctx_fn.meta = (up, down, ctx, h)
        # Every rank sends its first `down` rows (the halo of the band
        # above) and its last `up` rows (the halo of the band below).
        edges = _all_gather(torch.cat([x[:, :down], x[:, h - up:]], dim=1), ctx.group)
        parts = []
        if up and not ctx.first:
            parts.append(edges[ctx.index - 1][:, down:])
        parts.append(x)
        if down and not ctx.last:
            parts.append(edges[ctx.index + 1][:, :down])
        return torch.cat(parts, dim=1) if len(parts) > 1 else x.contiguous()

    @staticmethod
    def backward(ctx_fn, g):
        up, down, ctx, h = ctx_fn.meta
        top = up if (up and not ctx.first) else 0
        bottom = down if (down and not ctx.last) else 0
        gx = g[:, top:top + h].clone(memory_format=torch.contiguous_format)
        # Every rank sends the gradients of its halo rows: those from above
        # (zeros at the top edge) and those from below (zeros at the bottom).
        b, _, w, c = g.shape
        g_up = g[:, :top] if top else g.new_zeros((b, up, w, c))
        g_down = g[:, top + h:] if bottom else g.new_zeros((b, down, w, c))
        sent = _all_gather(torch.cat([g_up, g_down], dim=1), ctx.group)
        if up and not ctx.last:        # the band below fetched my last `up` rows
            gx[:, h - up:] += sent[ctx.index + 1][:, :up]
        if down and not ctx.first:     # the band above fetched my first `down` rows
            gx[:, :down] += sent[ctx.index - 1][:, up:]
        return gx, None, None, None


def halo_rows(x: torch.Tensor, up: int, down: int) -> tuple[torch.Tensor, int]:
    """(``x`` NHWC with ``up`` rows of the band above and ``down`` of the
    band below added where there is a neighbour, the number of rows added
    above); outside a spatial context, (``x``, 0).  Differentiable: the
    halo rows' gradients go back to their owners."""
    ctx = current()
    if ctx is None or (up == 0 and down == 0):
        return x, 0
    if max(up, down) > x.shape[1]:
        raise ValueError(f"a halo of {max(up, down)} rows reaches past a neighbour's "
                         f"band of {x.shape[1]} rows")
    return _HaloRows.apply(x, up, down, ctx), (0 if ctx.first else up)
