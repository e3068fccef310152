"""Depth decoders (reference ``networks/depth_decoder.py``), NCHW.

``DepthDecoder``: the Monodepth2 5-level U-Net decoder with skips, nearest x2
upsampling and a sigmoid disparity head at each scale (depth_decoder.py:10-55);
scale-s disparity is at 1/2^s of the input resolution. Its submodules carry
the reference's names, ``upconv_{i}_{j}`` and ``dispconv_{s}``, so the
state-dict keys are the reference's (``upconv_4_0.conv.conv.weight``, ...).

``LiteDepthDecoder``: the Lite-Mono decoder (depth_decoder.py:58-115):
3 levels (channels = encoder/2), bilinear x2 upsampling, and an extra
bilinear x2 upsample before each sigmoid head, so scale-s disparity is at
1/2^s of the full input resolution. The convs live in one ``decoder``
ModuleList in the reference's order — upconv(2,0), (2,1), (1,0), (1,1),
(0,0), (0,1), then one dispconv per scale — so the state-dict keys are the
reference's (``decoder.0.conv.conv.weight``, ...).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dynamo_depth_torch.models.layers import Conv3x3, ConvBlock
from dynamo_depth_torch.ops.warp import resize_bilinear, upsample2x_nearest


def _up2x_bilinear(x):
    return resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]))


class DepthDecoder(nn.Module):
    """Input: the 5-level ResNet pyramid [1/2, ..., 1/32]. Output
    {('disp', s): (B, 1, H/2^s, W/2^s)} for s in scales."""

    num_ch_dec = (16, 32, 64, 128, 256)

    def __init__(self, num_ch_enc, scales=(0, 1, 2, 3), num_output_channels=1, use_skips=True):
        super().__init__()
        self.scales = tuple(scales)
        self.use_skips = use_skips
        num_ch_enc = [int(c) for c in num_ch_enc]
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else self.num_ch_dec[i + 1]
            setattr(self, f"upconv_{i}_0", ConvBlock(cin, self.num_ch_dec[i]))
            cin = self.num_ch_dec[i] + (num_ch_enc[i - 1] if use_skips and i > 0 else 0)
            setattr(self, f"upconv_{i}_1", ConvBlock(cin, self.num_ch_dec[i]))
        for s in self.scales:
            setattr(self, f"dispconv_{s}", Conv3x3(self.num_ch_dec[s], num_output_channels))

    def forward(self, features):
        outputs = {}
        x = features[-1]
        for i in range(4, -1, -1):
            x = upsample2x_nearest(getattr(self, f"upconv_{i}_0")(x))
            if self.use_skips and i > 0:
                x = torch.cat([x, features[i - 1]], dim=1)
            x = getattr(self, f"upconv_{i}_1")(x)
            if i in self.scales:
                outputs[("disp", i)] = torch.sigmoid(getattr(self, f"dispconv_{i}")(x))
        return outputs


class LiteDepthDecoder(nn.Module):
    """Input: [1/4, 1/8, 1/16] LiteMono pyramid. Output
    {('disp', s): (B, 1, H/2^s, W/2^s)} for s in scales."""

    def __init__(self, num_ch_enc, scales=(0, 1, 2), num_output_channels=1, use_skips=True):
        super().__init__()
        self.scales = tuple(scales)
        self.use_skips = use_skips
        num_ch_enc = [int(c) for c in num_ch_enc]
        self.num_ch_dec = [c // 2 for c in num_ch_enc]
        convs = []
        for i in range(2, -1, -1):
            cin = num_ch_enc[-1] if i == 2 else self.num_ch_dec[i + 1]
            convs.append(ConvBlock(cin, self.num_ch_dec[i]))
            cin = self.num_ch_dec[i] + (num_ch_enc[i - 1] if use_skips and i > 0 else 0)
            convs.append(ConvBlock(cin, self.num_ch_dec[i]))
        for s in self.scales:
            convs.append(Conv3x3(self.num_ch_dec[s], num_output_channels))
        self.decoder = nn.ModuleList(convs)

    def forward(self, features):
        outputs = {}
        x = features[-1]
        for i in range(2, -1, -1):
            x = _up2x_bilinear(self.decoder[2 * (2 - i)](x))
            if self.use_skips and i > 0:
                x = torch.cat([x, features[i - 1]], dim=1)
            x = self.decoder[2 * (2 - i) + 1](x)
            if i in self.scales:
                d = self.decoder[6 + self.scales.index(i)](x)
                outputs[("disp", i)] = torch.sigmoid(_up2x_bilinear(d))
        return outputs
