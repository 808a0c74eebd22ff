"""Fused 3x3 convs over a virtual channel concat: the CUDA kernels and their
plain versions.

Port of ``maunet_tpu/ops/pallas/packed_vgg.py`` on plain NHWC tensors: the
TPU kernels' lane packing (``pack``, ``pack_weights``, ``s``) is a layout
device of the TPU's matrix unit and is not carried over.

``conv3x3_fused`` (``packed_conv3x3_fused``) computes
``relu?((sum_p conv3x3(x_p, w_p) + add) * scale + bias)`` with the scale
folded into the weights and into ``add`` first, as ``packed_vgg.py:480-487``
does, and rounds once to the parts' dtype.  Like the TPU kernel it computes
in the parts' dtype: bf16 parts launch ``csrc/conv3x3_fused.cu`` (tensor
cores), f32 parts ``csrc/conv3x3_f32.cu`` through
:func:`conv3x3_fused_f32` (FFMA: nothing rounded before the output).  Its
weights are prepared once by :func:`prepare_conv3x3`: folded, rounded and
laid out as the kernel of that dtype reads them.  A caller that keeps the
:class:`PreparedConv` (``models/blocks.VGGBlock`` in eval mode) pays for
none of that at later calls.

``conv3x3_pair_fused`` (``packed_pair_fused``) computes a whole VGGBlock,
two such convs with ReLU, in one launch, from two :class:`PreparedConv`; the
mid activation is rounded to the parts' dtype between them
(``packed_vgg.py:359-360``) and never reaches device memory.  bf16 parts
launch ``csrc/conv3x3_pair.cu`` (on A's main loop), f32 parts the pair entry
of ``csrc/conv3x3_f32.cu`` through :func:`conv3x3_pair_fused_f32`.  On the
card any other dtype raises (:func:`kernel_dtype`).
Each kernel's header says what bounds it on the H100.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from maunet_tpu_torch.ops.kernels import _build

MAX_PARTS = 5
# The widest mid and output the pair kernel takes (one 64-channel tile each).
PAIR_MAX_CHANNELS = 64


def _fold(weights: Sequence[torch.Tensor], scale: torch.Tensor | None,
          add: torch.Tensor | None, dtype: torch.dtype):
    """Scale folded into the (cout, cin_p, 3, 3) weights, rounded to
    ``dtype``, and into the compact ``add`` term, kept in f32."""
    if scale is not None:
        s = scale.float()
        weights = [w.float() * s[:, None, None, None] for w in weights]
        if add is not None:
            add = add.float() * s
    return ([w.to(dtype) for w in weights],
            None if add is None else add.float())


def expand_add(add: torch.Tensor, h: int) -> torch.Tensor:
    """Compact (B, 3, W, C) rows {y=0, interior, y=H-1} -> (B, H, W, C):
    row 0 at y = 0, row 2 at y = H-1 (H > 1), row 1 elsewhere."""
    sel = torch.ones(h, dtype=torch.long, device=add.device)
    sel[0] = 0
    if h > 1:
        sel[h - 1] = 2
    return add.index_select(1, sel)


# The layout of the prepared weights, as csrc/conv_tile.cuh reads them: K
# steps of TILE_K input channels, output-channel tiles of TILE_N (a last or
# only tile of at most TILE_N // 2 channels is half as wide).  The f32
# kernels (csrc/conv3x3_f32.cu) take the same output tiles and K steps of
# TILE_K_F32 channels.
TILE_K = 32
TILE_N = 64
TILE_K_F32 = 8
# The two layouts: wgmma's core matrices (bf16, and any dtype but f32 on the
# CPU) and the f32 kernels' [tap][channel][output] slabs.
WGMMA, FFMA = "wgmma", "ffma"
# The dtypes the CUDA kernels take, by the short name of their entry.
KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def kernel_dtype(what: str, dtype: torch.dtype) -> str:
    """Which entry of a conv kernel runs parts of ``dtype`` on the card:
    ``"bf16"`` or ``"f32"``.  Any other dtype raises, naming it (a CPU
    tensor of any dtype takes the plain version before this is asked)."""
    name = KERNEL_DTYPES.get(dtype)
    if name is None:
        raise ValueError(f"{what}: the CUDA kernels take bf16 or f32 parts, got {dtype}")
    return name


def layout_for(dtype: torch.dtype) -> str:
    """The layout :func:`prepare_conv3x3` gives weights of ``dtype``."""
    return FFMA if dtype == torch.float32 else WGMMA


def output_tiles(cout: int) -> list[tuple[int, int]]:
    """(first channel, width) of each output-channel tile of the kernel."""
    return [(nbase, TILE_N // 2 if cout - nbase <= TILE_N // 2 else TILE_N)
            for nbase in range(0, cout, TILE_N)]


def k_steps(cins: Sequence[int]) -> int:
    """K steps of one tile: each part's channels in slices of TILE_K."""
    return sum(-(-c // TILE_K) for c in cins)


@dataclasses.dataclass(frozen=True)
class PreparedConv:
    """One conv's weights as the kernel reads them, with its epilogue.

    ``packed``: flat, in the parts' dtype, in ``layout``.  Either layout
    holds, for each output tile of :func:`output_tiles` and each K step
    (part by part, slices of the layout's K channels), one contiguous slab,
    zero past ``cout`` and past the part's channels:

    - ``WGMMA`` (bf16; K = TILE_K): the ``width`` x TILE_K weights of each
      tap as the 8 x 8 core matrices that ``wgmma`` reads from shared
      memory: the folded weight of output channel ``nbase + 8 * j + r``, tap
      ``(tap // 3, tap % 3)`` and the step's channel ``16 * ks + 8 * c + e``
      is element ``tile_offset + (((((step * 9 + tap) * 2 + ks) * (width //
      8) + j) * 2 + c) * 8 + r) * 8 + e``;
    - ``FFMA`` (f32; K = TILE_K_F32): ``[tap][channel][output]``: the folded
      weight of output channel ``nbase + j``, tap ``tap`` and the step's
      channel ``k`` is element ``tile_offset + ((step * 9 + tap) *
      TILE_K_F32 + k) * width + j``.

    ``scale`` (which ``add`` still needs) and ``bias``: (cout,) f32 or None.
    ``cins``: the parts' channels."""

    packed: torch.Tensor
    scale: torch.Tensor | None
    bias: torch.Tensor | None
    cins: tuple[int, ...]
    cout: int
    layout: str

    def unpack(self) -> list[torch.Tensor]:
        """The folded (cout, cin_p, 3, 3) weight of each part, read back
        from ``packed``."""
        out = [self.packed.new_empty((self.cout, c, 3, 3)) for c in self.cins]
        tile_k = TILE_K_F32 if self.layout == FFMA else TILE_K
        offset = 0
        for nbase, width in output_tiles(self.cout):
            rows = min(width, self.cout - nbase)
            for wt, c in zip(out, self.cins):
                n = -(-c // tile_k)
                size = n * 9 * width * tile_k
                flat = self.packed[offset:offset + size]
                offset += size
                if self.layout == FFMA:
                    # (step, tap, k, j) -> (j, step, k, tap)
                    full = flat.reshape(n, 9, tile_k, width).permute(3, 0, 2, 1)
                else:
                    # (step, tap, ks, j, c, r, e) -> (j, r, step, ks, c, e, tap)
                    full = flat.reshape(n, 9, 2, width // 8, 2, 8, 8).permute(3, 5, 0, 2, 4, 6, 1)
                full = full.reshape(width, n * tile_k, 9)
                wt[nbase:nbase + rows] = full[:rows, :c].reshape(rows, c, 3, 3)
        return out


def prepare_conv3x3(weights: Sequence[torch.Tensor],
                    scale: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None,
                    dtype: torch.dtype = torch.bfloat16) -> PreparedConv:
    """Fold ``scale`` into the (cout, cin_p, 3, 3) weight slices, round them
    to ``dtype`` (the parts') and lay them out for the kernel of that dtype
    (:func:`layout_for`); keep ``scale`` and ``bias`` in f32.  A constant of
    the weights: no gradient passes."""
    prepare_conv3x3.calls += 1
    layout = layout_for(dtype)
    tile_k = TILE_K_F32 if layout == FFMA else TILE_K
    with torch.no_grad():
        ws, _ = _fold(weights, scale, None, dtype)
        cout = ws[0].shape[0]
        slabs = []
        for nbase, width in output_tiles(cout):
            rows = min(width, cout - nbase)
            for wt in ws:
                c = wt.shape[1]
                n = -(-c // tile_k)
                full = wt.new_zeros((width, n * tile_k, 9))
                full[:rows, :c] = wt[nbase:nbase + rows].reshape(rows, c, 9)
                if layout == FFMA:
                    # (j, step, k, tap) -> (step, tap, k, j)
                    slab = full.reshape(width, n, tile_k, 9).permute(1, 3, 2, 0)
                else:
                    # (j, r, step, ks, c, e, tap) -> (step, tap, ks, j, c, r, e)
                    slab = full.reshape(width // 8, 8, n, 2, 2, 8, 9).permute(2, 6, 3, 0, 4, 1, 5)
                slabs.append(slab.reshape(-1))
        return PreparedConv(
            packed=torch.cat(slabs),
            scale=None if scale is None else scale.detach().float().contiguous(),
            bias=None if bias is None else bias.detach().float().contiguous(),
            cins=tuple(wt.shape[1] for wt in ws), cout=cout, layout=layout)


prepare_conv3x3.calls = 0


def conv3x3_fused_plain(parts: Sequence[torch.Tensor],
                        weights: Sequence[torch.Tensor] | PreparedConv, *,
                        scale: torch.Tensor | None = None,
                        bias: torch.Tensor | None = None,
                        add: torch.Tensor | None = None,
                        relu: bool = False) -> torch.Tensor:
    """F.conv2d over the concatenated parts in f32 (operands rounded to the
    parts' dtype first, as the kernel reads them), then ``add``, ``bias``
    and ReLU in f32, rounded once to the parts' dtype.  Prepared weights are
    read back from their layout; they are folded and rounded already."""
    dtype = parts[0].dtype
    if isinstance(weights, PreparedConv):
        _require_epilogue_in(weights, scale, bias)
        ws, _ = _fold(weights.unpack(), None, None, dtype)
        _, add = _fold((), weights.scale, add, dtype)
        bias = weights.bias
    else:
        ws, add = _fold(weights, scale, add, dtype)
    x = torch.cat([p.float() for p in parts], dim=-1).permute(0, 3, 1, 2)
    y = F.conv2d(x, torch.cat(ws, dim=1).float(), padding=1).permute(0, 2, 3, 1)
    if add is not None:
        y = y + expand_add(add, y.shape[1])
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(dtype).contiguous()


def _require_epilogue_in(prepared: PreparedConv, scale, bias,
                         what: str = "conv3x3_fused") -> None:
    _build.require(scale is None and bias is None, what,
                   "prepared weights carry their scale and bias")


def _check_prepared_inputs(what: str, parts: Sequence[torch.Tensor],
                           prepared: PreparedConv, add: torch.Tensor | None,
                           dtype: torch.dtype) -> tuple[int, int, int, int]:
    """What the single-conv kernel of ``dtype`` asks of its parts, its
    prepared weights and ``add``; returns (B, H, W, cout).  On every
    launch's path, so a message is put together only when its check fails."""
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"{what}: takes 1-{MAX_PARTS} parts, got {len(parts)}")
    shape = parts[0].shape[:3]
    dev = parts[0].device
    for p in parts:
        if p.dim() != 4 or p.shape[:3] != shape:
            raise ValueError(f"{what}: parts must share (B, H, W), got {tuple(p.shape)}")
        if p.device != dev or p.dtype != dtype:
            raise ValueError(f"{what}: parts must be {KERNEL_DTYPES[dtype]} on {dev}, "
                             f"got {p.dtype} on {p.device}")
        if not p.is_contiguous():
            raise ValueError(f"{what}: parts must be contiguous")
    cins = tuple(p.shape[3] for p in parts)
    if cins != prepared.cins:
        raise ValueError(f"{what}: the weights' layout for parts of {prepared.cins} "
                         f"channels does not match parts of {cins}")
    _check_prepared_dtype(what, "weights", prepared, dtype)
    for name, t in (("prepared weights", prepared.packed), ("scale", prepared.scale),
                    ("bias", prepared.bias), ("add", add)):
        if t is not None and t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, not {dev}")
    b, h, w = shape
    if add is not None and add.shape != (b, 3, w, prepared.cout):
        raise ValueError(f"{what}: add must be {(b, 3, w, prepared.cout)}, "
                         f"got {tuple(add.shape)}")
    return b, h, w, prepared.cout


def _check_prepared_dtype(what: str, name: str, prepared: PreparedConv,
                          dtype: torch.dtype) -> None:
    """The parts and the prepared weights share the kernel's dtype, and the
    weights are in that kernel's layout."""
    if prepared.packed.dtype != dtype or prepared.layout != layout_for(dtype):
        raise ValueError(f"{what}: {name} prepared in {prepared.packed.dtype} "
                         f"({prepared.layout} layout), not {KERNEL_DTYPES[dtype]} as the parts")


def _launch_conv(what: str, entry: str, dtype: torch.dtype,
                 parts: Sequence[torch.Tensor],
                 weights: Sequence[torch.Tensor] | PreparedConv, scale, bias, add,
                 relu: bool) -> torch.Tensor:
    """Launch the single-conv entry ``entry`` of ``dtype`` on CUDA parts;
    raw weights are prepared in that dtype first."""
    # The kernel has no backward: train mode runs it only inside
    # ops/train_conv.TrainConv3x3.
    if isinstance(weights, PreparedConv):
        _require_epilogue_in(weights, scale, bias, what)
        prepared = weights
        _build.require_no_grad(what, *parts, add)
    else:
        _build.require_no_grad(what, *parts, *weights, scale, bias, add)
        _build.require(len(weights) >= 1, what, "one weight slice per part")
        prepared = prepare_conv3x3(weights, scale, bias, dtype)
    b, h, w, cout = _check_prepared_inputs(what, parts, prepared, add, dtype)
    add = None if add is None else add.float().contiguous()
    out = torch.empty((b, h, w, cout), dtype=dtype, device=parts[0].device)
    xs = (ctypes.c_void_p * len(parts))(*(p.data_ptr() for p in parts))
    cins = (ctypes.c_int * len(parts))(*prepared.cins)
    _build.launch(what, entry,
                  [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2, out,
                  ctypes.addressof(xs), prepared.packed.data_ptr(), ctypes.addressof(cins),
                  len(parts), None if add is None else add.data_ptr(),
                  None if prepared.bias is None else prepared.bias.data_ptr(),
                  out.data_ptr(), b, h, w, cout, int(relu),
                  None if prepared.scale is None else prepared.scale.data_ptr())
    return out


def conv3x3_fused(parts: Sequence[torch.Tensor],
                  weights: Sequence[torch.Tensor] | PreparedConv, *,
                  scale: torch.Tensor | None = None,
                  bias: torch.Tensor | None = None,
                  add: torch.Tensor | None = None,
                  relu: bool = False) -> torch.Tensor:
    """3x3 SAME conv over the virtual concat of ``parts``.

    parts[p]: (B, H, W, cin_p) NHWC, 1 to 5 of them; weights[p]: the
    (cout, cin_p, 3, 3) slice of the conv weight for that part; ``scale``,
    ``bias``: (cout,) epilogue vectors (``bias`` already holds the conv bias
    times the scale); ``add``: compact (B, 3, W, cout) pre-scale term of the
    broadcast embeddings.  ``weights`` may instead be the
    :class:`PreparedConv` that :func:`prepare_conv3x3` made of the weights,
    ``scale`` and ``bias``; raw weights are prepared on the fly, at every
    call.  Returns (B, H, W, cout) in the parts' dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of the parts' dtype, which takes any H, W and cin: bf16 parts
    ``csrc/conv3x3_fused.cu`` here, f32 parts :func:`conv3x3_fused_f32`.
    Any other dtype raises.
    """
    what = "conv3x3_fused"
    if _build.on_cpu(parts[0], what):
        return conv3x3_fused_plain(parts, weights, scale=scale, bias=bias,
                                   add=add, relu=relu)
    if kernel_dtype(what, parts[0].dtype) == "f32":
        return conv3x3_fused_f32(parts, weights, scale=scale, bias=bias, add=add, relu=relu)
    out = _launch_conv(what, "maunet_conv3x3_fused", torch.bfloat16, parts, weights,
                       scale, bias, add, relu)
    conv3x3_fused.launches += 1
    return out


conv3x3_fused.launches = 0


def conv3x3_fused_f32(parts: Sequence[torch.Tensor],
                      weights: Sequence[torch.Tensor] | PreparedConv, *,
                      scale: torch.Tensor | None = None,
                      bias: torch.Tensor | None = None,
                      add: torch.Tensor | None = None,
                      relu: bool = False) -> torch.Tensor:
    """:func:`conv3x3_fused` on f32 parts: kernel A's f32 entry
    (``csrc/conv3x3_f32.cu``), with weights prepared in f32.  It counts its
    own launches; :func:`conv3x3_fused` sends f32 parts here.  A CPU tensor
    takes the plain version; a CUDA tensor of another dtype raises."""
    what = "conv3x3_fused_f32"
    if _build.on_cpu(parts[0], what):
        return conv3x3_fused_plain(parts, weights, scale=scale, bias=bias,
                                   add=add, relu=relu)
    out = _launch_conv(what, "maunet_conv3x3_fused_f32", torch.float32, parts, weights,
                       scale, bias, add, relu)
    conv3x3_fused_f32.launches += 1
    return out


conv3x3_fused_f32.launches = 0


def _check_second_conv(what: str, dev: torch.device, cmid: int,
                       prepared: PreparedConv, dtype: torch.dtype) -> int:
    """What the pair kernel of ``dtype`` asks of its second conv; returns
    cout.  On every launch's path, so a message is put together only when
    its check fails."""
    if prepared.cins != (cmid,):
        raise ValueError(f"{what}: weight2 for {prepared.cins} input channels does not "
                         f"follow a {cmid}-channel mid")
    if cmid > PAIR_MAX_CHANNELS or prepared.cout > PAIR_MAX_CHANNELS:
        raise ValueError(f"{what}: takes mid and output widths up to {PAIR_MAX_CHANNELS}, "
                         f"got {cmid} and {prepared.cout}")
    _check_prepared_dtype(what, "weight2", prepared, dtype)
    for name, t in (("weight2", prepared.packed), ("bias2", prepared.bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, not {dev}")
    return prepared.cout


def conv3x3_pair_fused_plain(parts: Sequence[torch.Tensor],
                             weights1: Sequence[torch.Tensor] | PreparedConv,
                             weight2: torch.Tensor | PreparedConv, *,
                             scale1: torch.Tensor | None = None,
                             bias1: torch.Tensor | None = None,
                             scale2: torch.Tensor | None = None,
                             bias2: torch.Tensor | None = None,
                             add: torch.Tensor | None = None) -> torch.Tensor:
    """Two chained :func:`conv3x3_fused_plain` calls with ReLU: the mid
    activation is rounded to the parts' dtype between them."""
    mid = conv3x3_fused_plain(parts, weights1, scale=scale1, bias=bias1,
                              add=add, relu=True)
    w2 = weight2 if isinstance(weight2, PreparedConv) else [weight2]
    return conv3x3_fused_plain([mid], w2, scale=scale2, bias=bias2, relu=True)


def _launch_pair(what: str, entry: str, dtype: torch.dtype,
                 parts: Sequence[torch.Tensor],
                 weights1: Sequence[torch.Tensor] | PreparedConv,
                 weight2: torch.Tensor | PreparedConv, scale1, bias1, scale2, bias2,
                 add) -> torch.Tensor:
    """Launch the pair entry ``entry`` of ``dtype`` on CUDA parts; raw
    weights are prepared in that dtype first."""
    # No backward, as conv3x3_fused: train mode runs cuDNN convs.
    raw = [] if isinstance(weights1, PreparedConv) else list(weights1)
    raw += [] if isinstance(weight2, PreparedConv) else [weight2]
    _build.require_no_grad(what, *parts, add, scale1, bias1, scale2, bias2, *raw)
    if isinstance(weights1, PreparedConv):
        _require_epilogue_in(weights1, scale1, bias1, what)
        prepared1 = weights1
    else:
        _build.require(len(weights1) >= 1, what, "one weight slice per part")
        prepared1 = prepare_conv3x3(weights1, scale1, bias1, dtype)
    b, h, w, cmid = _check_prepared_inputs(what, parts, prepared1, add, dtype)
    if isinstance(weight2, PreparedConv):
        _require_epilogue_in(weight2, scale2, bias2, what)
        prepared2 = weight2
    else:
        _build.require(weight2.dim() == 4 and tuple(weight2.shape[2:]) == (3, 3), what,
                       f"weight2 must be (cout, cmid, 3, 3), got {tuple(weight2.shape)}")
        prepared2 = prepare_conv3x3([weight2], scale2, bias2, dtype)
    cout = _check_second_conv(what, parts[0].device, cmid, prepared2, dtype)
    add = None if add is None else add.float().contiguous()
    out = torch.empty((b, h, w, cout), dtype=dtype, device=parts[0].device)
    xs = (ctypes.c_void_p * len(parts))(*(p.data_ptr() for p in parts))
    cins = (ctypes.c_int * len(parts))(*prepared1.cins)
    _build.launch(what, entry,
                  [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2, out,
                  ctypes.addressof(xs), prepared1.packed.data_ptr(), ctypes.addressof(cins),
                  len(parts), prepared2.packed.data_ptr(),
                  None if add is None else add.data_ptr(),
                  None if prepared1.bias is None else prepared1.bias.data_ptr(),
                  None if prepared2.bias is None else prepared2.bias.data_ptr(),
                  out.data_ptr(), b, h, w, cmid, cout,
                  None if prepared1.scale is None else prepared1.scale.data_ptr())
    return out


def conv3x3_pair_fused(parts: Sequence[torch.Tensor],
                       weights1: Sequence[torch.Tensor] | PreparedConv,
                       weight2: torch.Tensor | PreparedConv, *,
                       scale1: torch.Tensor | None = None,
                       bias1: torch.Tensor | None = None,
                       scale2: torch.Tensor | None = None,
                       bias2: torch.Tensor | None = None,
                       add: torch.Tensor | None = None) -> torch.Tensor:
    """A whole VGGBlock: ``relu(conv3x3(relu(conv3x3(concat(parts)) ...)))``.

    ``parts`` and ``weights1`` as :func:`conv3x3_fused` takes them, with
    ``cmid`` output channels; ``weight2``: (cout, cmid, 3, 3); ``scale1``,
    ``bias1`` (cmid,) and ``scale2``, ``bias2`` (cout,): each conv's epilogue
    vectors; ``add``: conv1's compact (B, 3, W, cmid) pre-scale term.  Either
    conv's weights may instead be the :class:`PreparedConv` that
    :func:`prepare_conv3x3` made of them with their scale and bias (as
    ``models/blocks.VGGBlock`` keeps them); raw weights are prepared on the
    fly, at every call, and give the same bits.  Returns (B, H, W, cout) in
    the parts' dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of the parts' dtype, which takes any H, W and cin with cmid and cout up
    to 64: bf16 parts ``csrc/conv3x3_pair.cu`` here, f32 parts
    :func:`conv3x3_pair_fused_f32`.  Any other dtype raises.
    """
    what = "conv3x3_pair_fused"
    kw = dict(scale1=scale1, bias1=bias1, scale2=scale2, bias2=bias2)
    if _build.on_cpu(parts[0], what):
        return conv3x3_pair_fused_plain(parts, weights1, weight2, add=add, **kw)
    if kernel_dtype(what, parts[0].dtype) == "f32":
        return conv3x3_pair_fused_f32(parts, weights1, weight2, add=add, **kw)
    out = _launch_pair(what, "maunet_conv3x3_pair", torch.bfloat16, parts, weights1, weight2,
                       scale1, bias1, scale2, bias2, add)
    conv3x3_pair_fused.launches += 1
    return out


conv3x3_pair_fused.launches = 0


def conv3x3_pair_fused_f32(parts: Sequence[torch.Tensor],
                           weights1: Sequence[torch.Tensor] | PreparedConv,
                           weight2: torch.Tensor | PreparedConv, *,
                           scale1: torch.Tensor | None = None,
                           bias1: torch.Tensor | None = None,
                           scale2: torch.Tensor | None = None,
                           bias2: torch.Tensor | None = None,
                           add: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`conv3x3_pair_fused` on f32 parts: kernel G's f32 entry
    (``csrc/conv3x3_f32.cu``), the mid kept in f32 on chip.  It counts its
    own launches; :func:`conv3x3_pair_fused` sends f32 parts here.  A CPU
    tensor takes the plain version; a CUDA tensor of another dtype raises."""
    what = "conv3x3_pair_fused_f32"
    kw = dict(scale1=scale1, bias1=bias1, scale2=scale2, bias2=bias2)
    if _build.on_cpu(parts[0], what):
        return conv3x3_pair_fused_plain(parts, weights1, weight2, add=add, **kw)
    out = _launch_pair(what, "maunet_conv3x3_pair_f32", torch.float32, parts, weights1,
                       weight2, scale1, bias1, scale2, bias2, add)
    conv3x3_pair_fused_f32.launches += 1
    return out


conv3x3_pair_fused_f32.launches = 0
