"""Lite-Mono-8M hybrid CNN/transformer depth encoder, NCHW (reference
``networks/depth_encoder.py:305-431``).

3 stages (dims [64, 128, 224], depths [4, 4, 10]), a 3-conv stride-2 stem
plus a second stem conv over the concat with the avg-pooled input pyramid,
per-stage stacks of dilated-conv blocks ending in one LGFI
cross-covariance-attention block, drop-path linspace(0, rate), and the
(x-0.45)/0.225 input normalization. Feature pyramid out: [1/4, 1/8, 1/16].

Module and parameter names are the reference's, so its state-dict keys are
this module's (``downsample_layers.0.1.bn_gelu.bn.weight``,
``stages.2.9.xca.temperature``, ...). The dilated-conv blocks keep the
reference's ``norm`` LayerNorm, which their forward never uses, so those keys
match too. GELUs are exact (erf) and LayerNorm eps is 1e-6.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import BatchNorm2d, DropPath, normalize_image


def avg_pool_3x3_s2(x):
    """AvgPool2d(3, stride=2, padding=1) with count_include_pad=True."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


class _BNGELU(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.bn = BatchNorm2d(dim, eps=1e-5)

    def forward(self, x):
        return F.gelu(self.bn(x))


class Conv(nn.Module):
    """Bias-free conv, optionally followed by BatchNorm + GELU
    (depth_encoder.py:115-151)."""

    def __init__(self, cin, cout, kernel=3, stride=1, bn_act=False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=False)
        self.bn_gelu = _BNGELU(cout) if bn_act else None

    def forward(self, x):
        x = self.conv(x)
        return x if self.bn_gelu is None else self.bn_gelu(x)


class CDilated(nn.Module):
    """Depthwise dilated 3x3 conv, no bias."""

    def __init__(self, dim, dilation):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=dilation, dilation=dilation, groups=dim, bias=False)

    def forward(self, x):
        return self.conv(x)


class PositionalEncodingFourier(nn.Module):
    """Sine-cosine positional encoding + 1x1 projection
    (depth_encoder.py:9-44). Returns (B, dim, H, W)."""

    def __init__(self, dim, hidden_dim=32, temperature=10000.0):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.temperature = temperature
        self.token_projection = nn.Conv2d(2 * hidden_dim, dim, 1)

    def forward(self, B, H, W):
        dev = self.token_projection.weight.device
        scale = 2 * math.pi
        eps = 1e-6
        y = (torch.arange(1, H + 1, dtype=torch.float32, device=dev) / (H + eps) * scale)[None, :, None]
        x = (torch.arange(1, W + 1, dtype=torch.float32, device=dev) / (W + eps) * scale)[None, None, :]
        y = y.expand(B, H, W)
        x = x.expand(B, H, W)
        i = torch.arange(self.hidden_dim, dtype=torch.float32, device=dev)
        dim_t = self.temperature ** (2 * torch.floor(i / 2) / self.hidden_dim)

        def enc(v):
            p = v[..., None] / dim_t  # (B, H, W, hd)
            # sin of the even slots and cos of the odd ones, interleaved.
            return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], dim=-1).reshape(B, H, W, self.hidden_dim)

        pos = torch.cat([enc(y), enc(x)], dim=-1).permute(0, 3, 1, 2)
        return self.token_projection(pos)


class XCA(nn.Module):
    """Cross-covariance attention over channels (depth_encoder.py:47-87) on
    tokens (B, N, C): the attention matrix is d x d per head."""

    def __init__(self, dim, num_heads=8, qkv_bias=True):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, h, C // h).permute(2, 0, 3, 4, 1)  # (3, B, h, d, N)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = F.normalize(q, dim=-1, eps=1e-12)
        k = F.normalize(k, dim=-1, eps=1e-12)
        attn = torch.softmax(torch.matmul(q, k.transpose(-2, -1)) * self.temperature, dim=-1)
        out = torch.matmul(attn, v)  # (B, h, d, N)
        return self.proj(out.permute(0, 3, 1, 2).reshape(B, N, C))


class DilatedConv(nn.Module):
    """CDC block (depth_encoder.py:181-229): depthwise dilated 3x3 conv + BN,
    then a channels-last pointwise MLP (dim -> 6*dim -> dim) with layer-scale
    gamma, and a drop-path residual."""

    def __init__(self, dim, dilation=1, drop_path=0.0, layer_scale_init_value=1e-6, expan_ratio=6):
        super().__init__()
        self.ddwconv = CDilated(dim, dilation)
        self.bn1 = BatchNorm2d(dim, eps=1e-5)
        self.norm = nn.LayerNorm(dim, eps=1e-6)  # unused in forward, as in the reference
        self.pwconv1 = nn.Linear(dim, expan_ratio * dim)
        self.pwconv2 = nn.Linear(expan_ratio * dim, dim)
        self.gamma = nn.Parameter(layer_scale_init_value * torch.ones(dim))
        self.drop_path = DropPath(drop_path)

    def forward(self, x, generator=None):
        inp = x
        x = self.bn1(self.ddwconv(x)).permute(0, 2, 3, 1)
        x = self.gamma * self.pwconv2(F.gelu(self.pwconv1(x)))
        return inp + self.drop_path(x.permute(0, 3, 1, 2), generator)


class LGFI(nn.Module):
    """Local-Global Features Interaction block (depth_encoder.py:232-287)."""

    def __init__(self, dim, drop_path=0.0, layer_scale_init_value=1e-6, expan_ratio=6, use_pos_emb=True,
                 num_heads=6):
        super().__init__()
        self.pos_embd = PositionalEncodingFourier(dim=dim) if use_pos_emb else None
        self.norm_xca = nn.LayerNorm(dim, eps=1e-6)
        self.gamma_xca = nn.Parameter(layer_scale_init_value * torch.ones(dim))
        self.xca = XCA(dim, num_heads=num_heads)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, expan_ratio * dim)
        self.pwconv2 = nn.Linear(expan_ratio * dim, dim)
        self.gamma = nn.Parameter(layer_scale_init_value * torch.ones(dim))
        self.drop_path = DropPath(drop_path)

    def forward(self, x, generator=None):
        B, C, H, W = x.shape
        inp = x
        t = x.reshape(B, C, H * W).transpose(1, 2)  # (B, N, C)
        if self.pos_embd is not None:
            t = t + self.pos_embd(B, H, W).reshape(B, C, H * W).transpose(1, 2)
        t = t + self.gamma_xca * self.xca(self.norm_xca(t))
        t = self.gamma * self.pwconv2(F.gelu(self.pwconv1(self.norm(t))))
        t = t.transpose(1, 2).reshape(B, C, H, W)
        return inp + self.drop_path(t, generator)


class LiteMono(nn.Module):
    """Lite-Mono-8M encoder: returns [f_1/4 (64), f_1/8 (128), f_1/16 (224)]."""

    _dilation = ((1, 2, 3), (1, 2, 3), (1, 2, 3, 1, 2, 3, 2, 4, 6))

    def __init__(self, in_chans=3, dims=(64, 128, 224), depths=(4, 4, 10), drop_path_rate=0.4,
                 heads=(8, 8, 8), use_pos_embd_xca=(True, False, False)):
        super().__init__()
        self.num_ch_enc = np.array(dims)
        self.depths = depths
        self.downsample_layers = nn.ModuleList([
            nn.Sequential(
                Conv(in_chans, dims[0], 3, 2, bn_act=True),
                Conv(dims[0], dims[0], 3, 1, bn_act=True),
                Conv(dims[0], dims[0], 3, 1, bn_act=True),
            ),
            nn.Sequential(Conv(dims[0] * 2 + in_chans, dims[1], 3, 2)),
            nn.Sequential(Conv(dims[1] * 2 + in_chans, dims[2], 3, 2)),
        ])
        self.stem2 = nn.Sequential(Conv(dims[0] + in_chans, dims[0], 3, 2))
        dp_rates = np.linspace(0, drop_path_rate, sum(depths))
        stages = []
        cur = 0
        for i in range(3):
            blocks = []
            for j in range(depths[i]):
                rate = float(dp_rates[cur + j])
                if j == depths[i] - 1:  # one LGFI closes each stage
                    blocks.append(LGFI(dims[i], drop_path=rate, use_pos_emb=use_pos_embd_xca[i], num_heads=heads[i]))
                else:
                    blocks.append(DilatedConv(dims[i], dilation=self._dilation[i][j], drop_path=rate))
            stages.append(nn.ModuleList(blocks))
            cur += depths[i]
        self.stages = nn.ModuleList(stages)

    def forward(self, x, generator=None):
        x = normalize_image(x)
        x_down = []
        cur = x
        for _ in range(3):  # avg-pooled input pyramid at 1/2, 1/4, 1/8
            cur = avg_pool_3x3_s2(cur)
            x_down.append(cur)

        h = self.downsample_layers[0](x)
        h = self.stem2(torch.cat([h, x_down[0]], dim=1))

        features = []
        stage_in = h
        for i in range(3):
            for block in self.stages[i]:
                h = block(h, generator)
            features.append(h)
            if i < 2:
                # downsample: concat [stage input, stage output, pooled input]
                h = self.downsample_layers[i + 1](torch.cat([stage_in, h, x_down[i + 1]], dim=1))
                stage_in = h
        return features
