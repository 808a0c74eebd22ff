"""Metadata-augmented classic U-Net.

Port of ``maunet_tpu/models/unet.py`` (reference ``UrbanPredictor_unet``,
src/model.py:195-292): 4-down/4-up U-Net over the 23-channel tile stack, the
temporal (LSTM) and metadata (MLP) embeddings broadcast in **only at the
bottleneck**, align-corners upsampling with exact-size fix-ups for odd
chains, a 1x1 head, and tanh on the NDVI channel only (2-channel outputs).

Inputs and outputs keep the JAX layout: maps (B, H, W, C) NHWC, series
(B, T), metadata (B, F); the output is (B, H, W, out_channels) f32.  The
first conv takes the 23 input channels as they are: the fused kernel reads
any channel count, so no zero channel is padded on.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from maunet_tpu_torch.models.blocks import VGGBlock, max_pool_2x2
from maunet_tpu_torch.models.encoders import MetadataEncoder, TemporalEncoder
from maunet_tpu_torch.ops.resize import upsample_like


class MetaUNet(nn.Module):

    def __init__(self, in_channels: int = 23, out_channels: int = 2,
                 temporal_dim: int = 64, meta_dim: int = 64,
                 lstm_dim: int = 96, base_filters: int = 64,
                 meta_features: int = 8, temporal_embeddings: bool = True,
                 metadata_embeddings: bool = True,
                 lstm_mask_mode: str = "per_sample",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 bn_fused: bool = False, fuse_pair: bool = False):
        super().__init__()
        self.out_channels = out_channels
        self.compute_dtype = compute_dtype
        nb = [base_filters * 2 ** i for i in range(5)]
        # Registration order is the reference's (src/model.py:195-240):
        # encoders first.  It fixes the parameter indices of a torch
        # optimizer state_dict (maunet_tpu/interop/torch_export.py
        # reference_param_order).
        emb = 0
        self.temporal_encoder = self.meta_encoder = None
        if temporal_embeddings:
            self.temporal_encoder = TemporalEncoder(
                lstm_dim, temporal_dim, mask_mode=lstm_mask_mode,
                compute_dtype=compute_dtype)
            emb += temporal_dim
        if metadata_embeddings:
            self.meta_encoder = MetadataEncoder(meta_features, meta_dim,
                                                compute_dtype=compute_dtype)
            emb += meta_dim
        vgg = lambda cin, cout: VGGBlock(cin, cout, cout, compute_dtype,
                                         bn_fused=bn_fused, fuse_pair=fuse_pair)
        self.conv0_0 = vgg(in_channels, nb[0])
        self.conv1_0 = vgg(nb[0], nb[1])
        self.conv2_0 = vgg(nb[1], nb[2])
        self.conv3_0 = vgg(nb[2], nb[3])
        self.conv4_0 = vgg(nb[3] + emb, nb[4])
        self.conv3_1 = vgg(nb[3] + nb[4], nb[3])
        self.conv2_1 = vgg(nb[2] + nb[3], nb[2])
        self.conv1_1 = vgg(nb[1] + nb[2], nb[1])
        self.conv0_1 = vgg(nb[0] + nb[1], nb[0])
        self.final = nn.Conv2d(nb[0], out_channels, 1)

    def forward(self, maps: torch.Tensor, temp_series: torch.Tensor,
                metadata: torch.Tensor,
                temp_lengths: torch.Tensor | None = None) -> torch.Tensor:
        cd = self.compute_dtype
        x0_0 = self.conv0_0([maps.to(cd)])
        x1_0 = self.conv1_0([max_pool_2x2(x0_0)])
        x2_0 = self.conv2_0([max_pool_2x2(x1_0)])
        x3_0 = self.conv3_0([max_pool_2x2(x2_0)])

        # Bottleneck: embeddings enter as (B, 1, 1, D) broadcast parts.
        fused = [max_pool_2x2(x3_0)]
        b = maps.shape[0]
        if self.temporal_encoder is not None:
            temb = self.temporal_encoder(temp_series, temp_lengths)
            fused.append(temb.reshape(b, 1, 1, -1))
        if self.meta_encoder is not None:
            fused.append(self.meta_encoder(metadata).reshape(b, 1, 1, -1))
        x4_0 = self.conv4_0(fused)

        # Decoder: scale-2 upsample + exact-size fix-up, skip and upsample
        # passed as parts (reference :279-282, double interpolation for odd
        # sizes).
        def up_cat(deep, skip):
            return [skip, upsample_like(deep, skip.shape[1:3]).to(cd)]

        x3_1 = self.conv3_1(up_cat(x4_0, x3_0))
        x2_1 = self.conv2_1(up_cat(x3_1, x2_0))
        x1_1 = self.conv1_1(up_cat(x2_1, x1_0))
        x0_1 = self.conv0_1(up_cat(x1_1, x0_0))

        # 1x1 head in compute_dtype, activation in f32.
        out = F.linear(x0_1, self.final.weight[:, :, 0, 0].to(cd),
                       self.final.bias.to(cd)).float()
        # tanh on NDVI (channel 0) only, for 2-channel outputs (reference
        # :286-291).
        if self.out_channels == 2:
            out = torch.cat([torch.tanh(out[..., 0:1]), out[..., 1:2]], dim=-1)
        return out
