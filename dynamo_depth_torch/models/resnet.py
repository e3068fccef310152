"""ResNet feature encoder (reference ``networks/resnet_encoder.py``).

The torchvision trunk under an ``encoder.`` prefix, so the state-dict keys
are the reference's (``encoder.conv1.weight``, ``encoder.layer1.0.bn1...``).
Returns the 5-level pyramid [relu1 (1/2), layer1 (1/4), layer2 (1/8),
layer3 (1/16), layer4 (1/32)] with the (x-0.45)/0.225 input normalization.
``num_input_images > 1`` widens conv1 to stacked RGB frames.

Layout: the stem's conv1 takes the stacked frames (3, 6 or 9 channels) in
NCHW, and its output takes the layout of ``layer1``-``layer4``'s weights,
which ``models/model.py::lay_out`` sets: channels-last (NHWC) on a CUDA
card, so that every feature of the pyramid is, and NCHW elsewhere. On an
H100, cuDNN runs the trunk's 1x1 and most of its 3x3 convolutions faster in
NHWC (the bottleneck's 64 -> 256 expansion at batch 36, 48x160, 5x), and the
stem's 7x7 over a few channels slower.
"""

from __future__ import annotations

import numpy as np
import torch.nn as nn
import torch.nn.functional as F

from dynamo_depth_torch.models.layers import BatchNorm2d, memory_format, normalize_image

_BLOCKS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
_BOTTLENECK = {18: False, 34: False, 50: True, 101: True, 152: True}


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (
            nn.Sequential(_conv(inplanes, planes, 1, stride), BatchNorm2d(planes)) if downsample else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (
            nn.Sequential(_conv(inplanes, planes * 4, 1, stride), BatchNorm2d(planes * 4)) if downsample else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class _Trunk(nn.Module):
    def __init__(self, num_layers, in_channels):
        super().__init__()
        block = Bottleneck if _BOTTLENECK[num_layers] else BasicBlock
        self.conv1 = _conv(in_channels, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for stage, (planes, n_blocks) in enumerate(zip([64, 128, 256, 512], _BLOCKS[num_layers])):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                ds = b == 0 and (stride != 1 or inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes, stride if b == 0 else 1, ds))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))


class ResnetEncoder(nn.Module):
    """5-level feature pyramid encoder over ``num_input_images`` stacked RGB
    frames (NCHW input with 3 * num_input_images channels); the features are
    laid out as the trunk's weights."""

    def __init__(self, num_layers=18, num_input_images=1):
        super().__init__()
        self.num_input_images = num_input_images
        self.num_ch_enc = np.array([64, 64, 128, 256, 512])
        if num_layers > 34:
            self.num_ch_enc[1:] *= 4
        self.encoder = _Trunk(num_layers, 3 * num_input_images)

    def forward(self, x):
        if x.shape[1] != 3 * self.num_input_images:
            raise ValueError(f"expected {3 * self.num_input_images} input channels, got {x.shape[1]}")
        e = self.encoder
        x = F.relu(e.bn1(e.conv1(normalize_image(x))))
        # layer1's 3x3 weight tells the trunk's layout (a 1x1 weight reads
        # the same in both).
        x = x.contiguous(memory_format=memory_format(e.layer1[0].conv2.weight))
        features = [x]
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in (e.layer1, e.layer2, e.layer3, e.layer4):
            x = stage(x)
            features.append(x)
        return features
