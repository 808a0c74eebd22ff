"""The plain reference of both model families: PyTorch ops in float32.

Written from the published architecture (src/model.py of
github.com/4l3x4ndre/Metadata-Augmented-UNET-for-LST-NDVI): VGG blocks of
(3x3 conv, BatchNorm, ReLU) x 2, 2x2 max pools, bilinear align-corners
upsampling, the LSTM over the monthly series and the metadata MLP, their
embeddings tiled over the bottleneck (U-Net) or over every decoder node
(U-Net++), a 1x1 head and tanh on the NDVI channel.  Tensors are NCHW;
inputs and outputs are NHWC as the program's.  The module names are the
reference's, so one state_dict loads into this model and into the program.

Departures from the published code, each one the program's definition of the
same model: the LSTM state of a sample freezes at its length
(``per_sample``) or at the batch's longest (``batch_max``, as the published
checkpoints were trained), and train-mode BatchNorm leaves the running
statistics alone (nothing here reads them after a training step).

``quant`` is applied to the input and the weight of every conv and dense
layer: the identity for the reference, a cast to a lower precision for the
control.  Set ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False around a call (``f32_exact``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


@contextlib.contextmanager
def f32_exact():
    """Full float32 matrix products and convolutions (no TF32) inside."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


class Block(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(cout)

    def forward(self, x, train: bool, quant):
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = F.conv2d(quant(x), quant(conv.weight), conv.bias, padding=1)
            if train:
                x = F.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)
            else:
                x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                 training=False, eps=bn.eps)
            x = F.relu(x)
        return x


class TemporalEncoder(nn.Module):
    def __init__(self, hidden: int, out: int):
        super().__init__()
        self.lstm = nn.LSTM(1, hidden, batch_first=True)
        self.fc = nn.Linear(hidden, out)

    def forward(self, series, lengths, quant):
        """series (B, T) f32, lengths (B,) at which each state freezes."""
        p = self.lstm
        b = series.shape[0]
        hidden = p.hidden_size
        h = series.new_zeros(b, hidden)
        c = series.new_zeros(b, hidden)
        steps = int(lengths.max()) if lengths.numel() else 0
        w_ih, w_hh = quant(p.weight_ih_l0), quant(p.weight_hh_l0)
        bias = p.bias_ih_l0 + p.bias_hh_l0
        for t in range(steps):
            gates = series[:, t:t + 1] * w_ih[:, 0] + quant(h) @ w_hh.t() + bias
            i, f, g, o = gates.chunk(4, dim=1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            live = (t < lengths)[:, None]
            h = torch.where(live, h_new, h)
            c = torch.where(live, c_new, c)
        return F.linear(quant(h), quant(self.fc.weight), self.fc.bias)


class MetaEncoder(nn.Module):
    def __init__(self, features: int, out: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(features, 32), nn.ReLU(), nn.Linear(32, out))

    def forward(self, meta, quant):
        l1, l2 = self.fc[0], self.fc[2]
        x = F.relu(F.linear(quant(meta), quant(l1.weight), l1.bias))
        return F.linear(quant(x), quant(l2.weight), l2.bias)


def up2(x, size):
    """Scale-2 align-corners upsample, then a resize to ``size`` if missed
    (src/model.py:243-246)."""
    y = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
    if tuple(y.shape[-2:]) != tuple(size):
        y = F.interpolate(y, size=size, mode="bilinear", align_corners=True)
    return y


class UNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        nb = [cfg["base_filters"] * 2 ** i for i in range(5)]
        self.temporal_encoder = TemporalEncoder(cfg["lstm_hidden"], cfg["temporal_dim"])
        self.meta_encoder = MetaEncoder(cfg["meta_features"], cfg["meta_dim"])
        emb = cfg["temporal_dim"] + cfg["meta_dim"]
        cin = cfg["in_channels"]
        self.conv0_0 = Block(cin, nb[0])
        self.conv1_0 = Block(nb[0], nb[1])
        self.conv2_0 = Block(nb[1], nb[2])
        self.conv3_0 = Block(nb[2], nb[3])
        self.conv4_0 = Block(nb[3] + emb, nb[4])
        self.conv3_1 = Block(nb[3] + nb[4], nb[3])
        self.conv2_1 = Block(nb[2] + nb[3], nb[2])
        self.conv1_1 = Block(nb[1] + nb[2], nb[1])
        self.conv0_1 = Block(nb[0] + nb[1], nb[0])
        self.final = nn.Conv2d(nb[0], cfg["out_channels"], 1)

    def forward(self, x, emb, train, quant):
        pool = lambda t: F.max_pool2d(t, 2)
        x0_0 = self.conv0_0(x, train, quant)
        x1_0 = self.conv1_0(pool(x0_0), train, quant)
        x2_0 = self.conv2_0(pool(x1_0), train, quant)
        x3_0 = self.conv3_0(pool(x2_0), train, quant)
        p = pool(x3_0)
        tiled = emb[:, :, None, None].expand(-1, -1, *p.shape[-2:])
        x4_0 = self.conv4_0(torch.cat([p, tiled], 1), train, quant)
        x3_1 = self.conv3_1(torch.cat([x3_0, up2(x4_0, x3_0.shape[-2:])], 1), train, quant)
        x2_1 = self.conv2_1(torch.cat([x2_0, up2(x3_1, x2_0.shape[-2:])], 1), train, quant)
        x1_1 = self.conv1_1(torch.cat([x1_0, up2(x2_1, x1_0.shape[-2:])], 1), train, quant)
        x0_1 = self.conv0_1(torch.cat([x0_0, up2(x1_1, x0_0.shape[-2:])], 1), train, quant)
        return F.conv2d(quant(x0_1), quant(self.final.weight), self.final.bias)


class UNetPP(nn.Module):
    """Nested U-Net without deep supervision: the embeddings enter every
    decoder node, and each node's lower input is resized straight to the
    node's size (src/model.py:111-121)."""

    NODES = ((0, 1), (1, 1), (2, 1), (3, 1), (0, 2), (1, 2), (2, 2), (0, 3), (1, 3), (0, 4))

    def __init__(self, cfg: dict):
        super().__init__()
        nb = [cfg["base_filters"] * 2 ** i for i in range(5)]
        emb = cfg["temporal_dim"] + cfg["meta_dim"]
        self.conv0_0 = Block(cfg["in_channels"], nb[0])
        for lvl in range(1, 5):
            setattr(self, f"conv{lvl}_0", Block(nb[lvl - 1], nb[lvl]))
        for lvl, j in self.NODES:
            setattr(self, f"conv{lvl}_{j}", Block(j * nb[lvl] + nb[lvl + 1] + emb, nb[lvl]))
        self.temporal_encoder = TemporalEncoder(cfg["lstm_hidden"], cfg["temporal_dim"])
        self.meta_encoder = MetaEncoder(cfg["meta_features"], cfg["meta_dim"])
        self.final = nn.Conv2d(nb[0], cfg["out_channels"], 1)

    def forward(self, x, emb, train, quant):
        h, w = x.shape[-2:]
        nodes = {}
        for lvl in range(5):
            src = x if lvl == 0 else F.max_pool2d(nodes[(lvl - 1, 0)], 2)
            nodes[(lvl, 0)] = getattr(self, f"conv{lvl}_0")(src, train, quant)
        for lvl, j in sorted(self.NODES, key=lambda n: (n[0] + n[1], -n[0])):
            size = (h // 2 ** lvl, w // 2 ** lvl)
            low = F.interpolate(nodes[(lvl + 1, j - 1)], size=size, mode="bilinear",
                                align_corners=True)
            tiled = emb[:, :, None, None].expand(-1, -1, *size)
            parts = [nodes[(lvl, k)] for k in range(j)] + [low, tiled]
            nodes[(lvl, j)] = getattr(self, f"conv{lvl}_{j}")(torch.cat(parts, 1), train, quant)
        return F.conv2d(quant(nodes[(0, 4)]), quant(self.final.weight), self.final.bias)


class Reference(nn.Module):
    """The model under ``.model``, as the published checkpoints hold it."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.model = UNet(cfg) if cfg["model_type"] == "unet" else UNetPP(cfg)

    def forward(self, maps, series, metadata, lengths, *, train: bool = False,
                mask_mode: str = "per_sample", quant=identity):
        """maps (B, H, W, C), series (B, T), metadata (B, F), lengths (B,)
        -> (B, H, W, 2) f32: tanh(NDVI), LST in normalised units."""
        net = self.model
        lengths = lengths.to(torch.int64)
        if mask_mode == "batch_max":
            lengths = lengths.max().expand(lengths.shape[0])
        temb = net.temporal_encoder(series.float(), lengths, quant)
        memb = net.meta_encoder(metadata.float(), quant)
        x = maps.float().permute(0, 3, 1, 2)
        out = net(x, torch.cat([temb, memb], 1), train, quant).permute(0, 2, 3, 1)
        return torch.cat([torch.tanh(out[..., :1]), out[..., 1:]], -1)
