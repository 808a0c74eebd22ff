"""Metadata-augmented nested U-Net++.

Port of ``maunet_tpu/models/unetpp.py`` (reference ``UrbanPredictor_unetpp``,
src/model.py:51-193): the dense skip grid x_{i,j}, the combined temporal +
metadata embedding broadcast into **every decoder node** (all conv_{i,j>=1})
as a (B, 1, 1, D) part, **one** align-corners resize straight to the node's
level size ``H // 2**lvl`` (reference :111-121), optional deep supervision
with four raw heads (:90-94,180-185), and tanh on the NDVI channel only for
2-channel outputs (:187-193).

As in the JAX module, and unlike the reference (which swallows the ablation
flags, src/model.py:53), a flag that is off removes its encoder and its
channels; the checkpoint importer sets both on for U-Net++ checkpoints.

Submodules are registered in the reference's order (convs, then the
encoders after ``conv0_4``, then the heads): it fixes the parameter indices
of a torch optimizer state_dict (``maunet_tpu/interop/torch_export.py``
``reference_param_order``).  Lane packing is not ported.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from maunet_tpu_torch.models.blocks import VGGBlock, max_pool_2x2
from maunet_tpu_torch.models.encoders import MetadataEncoder, TemporalEncoder
from maunet_tpu_torch.ops.resize import resize_align_corners

Outputs = torch.Tensor | tuple[torch.Tensor, ...]


class MetaUNetPP(nn.Module):

    def __init__(self, in_channels: int = 23, out_channels: int = 2,
                 temporal_dim: int = 64, meta_dim: int = 64,
                 lstm_dim: int = 96, base_filters: int = 32,
                 meta_features: int = 8, deep_supervision: bool = False,
                 temporal_embeddings: bool = True,
                 metadata_embeddings: bool = True,
                 lstm_mask_mode: str = "per_sample",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 bn_fused: bool = False, fuse_pair: bool = False,
                 train_fused_conv: bool = False, remat: bool = False):
        super().__init__()
        self.out_channels = out_channels
        self.deep_supervision = deep_supervision
        self.compute_dtype = compute_dtype
        nb = [base_filters * 2 ** i for i in range(5)]
        emb = (temporal_dim if temporal_embeddings else 0) \
            + (meta_dim if metadata_embeddings else 0)
        # group_spatial as JAX sets it for U-Net++ (unetpp.py:95-99).
        vgg = lambda cin, lvl: VGGBlock(cin, nb[lvl], nb[lvl], compute_dtype,
                                        bn_fused=bn_fused, fuse_pair=fuse_pair,
                                        train_fused=train_fused_conv,
                                        group_spatial=True, remat=remat)
        # Node x_{lvl,j} reads j skips of its own level, the resized node
        # below and the embedding.
        node = lambda lvl, j: vgg(j * nb[lvl] + nb[lvl + 1] + emb, lvl)
        self.conv0_0 = vgg(in_channels, 0)
        self.conv1_0 = vgg(nb[0], 1)
        self.conv2_0 = vgg(nb[1], 2)
        self.conv3_0 = vgg(nb[2], 3)
        self.conv4_0 = vgg(nb[3], 4)
        self.conv0_1 = node(0, 1)
        self.conv1_1 = node(1, 1)
        self.conv2_1 = node(2, 1)
        self.conv3_1 = node(3, 1)
        self.conv0_2 = node(0, 2)
        self.conv1_2 = node(1, 2)
        self.conv2_2 = node(2, 2)
        self.conv0_3 = node(0, 3)
        self.conv1_3 = node(1, 3)
        self.conv0_4 = node(0, 4)
        self.temporal_encoder = self.meta_encoder = None
        if temporal_embeddings:
            self.temporal_encoder = TemporalEncoder(
                lstm_dim, temporal_dim, mask_mode=lstm_mask_mode,
                compute_dtype=compute_dtype)
        if metadata_embeddings:
            self.meta_encoder = MetadataEncoder(meta_features, meta_dim,
                                                compute_dtype=compute_dtype)
        if deep_supervision:
            self.final1 = nn.Conv2d(nb[0], out_channels, 1)
            self.final2 = nn.Conv2d(nb[0], out_channels, 1)
            self.final3 = nn.Conv2d(nb[0], out_channels, 1)
            self.final4 = nn.Conv2d(nb[0], out_channels, 1)
        else:
            self.final = nn.Conv2d(nb[0], out_channels, 1)

    def forward(self, maps: torch.Tensor, temp_series: torch.Tensor,
                metadata: torch.Tensor,
                temp_lengths: torch.Tensor | None = None) -> Outputs:
        cd = self.compute_dtype
        b, h, w = maps.shape[:3]

        # Encode the non-spatial context once (reference :125-126).
        embs = []
        if self.temporal_encoder is not None:
            embs.append(self.temporal_encoder(temp_series, temp_lengths))
        if self.meta_encoder is not None:
            embs.append(self.meta_encoder(metadata))
        emb = [torch.cat(embs, dim=-1).reshape(b, 1, 1, -1)] if embs else []

        def up(x, lvl):
            # One resize straight to the level's size: repeated 2x2 floor
            # pooling equals floor division by 2**lvl.
            return resize_align_corners(x, (h // 2 ** lvl, w // 2 ** lvl)).to(cd)

        x0_0 = self.conv0_0([maps.to(cd)])
        x1_0 = self.conv1_0([max_pool_2x2(x0_0)])
        x0_1 = self.conv0_1([x0_0, up(x1_0, 0), *emb])

        x2_0 = self.conv2_0([max_pool_2x2(x1_0)])
        x1_1 = self.conv1_1([x1_0, up(x2_0, 1), *emb])
        x0_2 = self.conv0_2([x0_0, x0_1, up(x1_1, 0), *emb])

        x3_0 = self.conv3_0([max_pool_2x2(x2_0)])
        x2_1 = self.conv2_1([x2_0, up(x3_0, 2), *emb])
        x1_2 = self.conv1_2([x1_0, x1_1, up(x2_1, 1), *emb])
        x0_3 = self.conv0_3([x0_0, x0_1, x0_2, up(x1_2, 0), *emb])

        x4_0 = self.conv4_0([max_pool_2x2(x3_0)])
        x3_1 = self.conv3_1([x3_0, up(x4_0, 3), *emb])
        x2_2 = self.conv2_2([x2_0, x2_1, up(x3_1, 2), *emb])
        x1_3 = self.conv1_3([x1_0, x1_1, x1_2, up(x2_2, 1), *emb])
        x0_4 = self.conv0_4([x0_0, x0_1, x0_2, x0_3, up(x1_3, 0), *emb])

        # 1x1 heads in compute_dtype, activation in f32.
        def head(conv, x):
            return F.linear(x, conv.weight[:, :, 0, 0].to(cd), conv.bias.to(cd)).float()

        if self.deep_supervision:
            # Four raw heads, no output activation (reference :180-185).
            return (head(self.final1, x0_1), head(self.final2, x0_2),
                    head(self.final3, x0_3), head(self.final4, x0_4))
        out = head(self.final, x0_4)
        if self.out_channels == 2:
            out = torch.cat([torch.tanh(out[..., 0:1]), out[..., 1:2]], dim=-1)
        return out
