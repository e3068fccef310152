"""Shared building blocks (reference ``networks/layers.py:85-120``), in NCHW
or channels-last (NHWC), as their input is laid out."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv3x3(nn.Module):
    """Reflection-pad + 3x3 conv (layers.py:100-116).

    An axis of one pixel is padded as ``jnp.pad(..., mode="reflect")`` pads
    it, by repeating the pixel (the JAX package's ``reflect_pad``); torch's
    reflection padding refuses it. monodepthv2 at 32x64 has a 1x2 bottom
    level."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1, padding_mode="reflect")

    def forward(self, x):
        if min(x.shape[-2:]) > 1:
            return F.conv2d(reflect_pad1(x), self.conv.weight, self.conv.bias)
        for dim, pad in ((-1, (1, 1, 0, 0)), (-2, (0, 0, 1, 1))):
            x = F.pad(x, pad, mode="reflect" if x.shape[dim] > 1 else "replicate")
        return F.conv2d(x, self.conv.weight, self.conv.bias)


class ConvBlock(nn.Module):
    """Conv3x3 + ELU (layers.py:85-97)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels)

    def forward(self, x):
        return F.elu(self.conv(x))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose running statistics follow the JAX package's flax
    BatchNorm: ``running = 0.9 * running + 0.1 * batch_stat`` with the
    *biased* batch variance (``resnet.py:73-74``, ``litemono.py:131,217``).
    ``nn.BatchNorm2d`` would update with the unbiased variance. The
    normalization itself uses the biased batch variance in both. Under a
    bfloat16 autocast the statistics are taken in float32, as flax takes
    them, and the running buffers stay float32."""

    def __init__(self, num_features, eps=1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class DropPath(nn.Module):
    """Stochastic depth: drop the residual branch per sample (timm DropPath),
    drawing from the ``torch.Generator`` the caller passes."""

    def __init__(self, rate=0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = (torch.rand(shape, generator=generator, device=x.device) < keep).to(x.dtype)
        return x / keep * mask


def memory_format(x):
    """The memory format ``x`` is laid out in: ``torch.channels_last`` where
    its strides are NHWC's and not NCHW's too, else NCHW's."""
    if not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def reflect_pad1(x):
    """Reflection padding of one pixel on each side of H and W, laid out as
    ``x`` is. CUDA's 2-D reflection padding returns NCHW whatever its input;
    a channels-last map is padded as the (H, W, C) volume of its NHWC view,
    C unpadded, and so stays channels-last."""
    if memory_format(x) == torch.channels_last:
        return F.pad(x.permute(0, 2, 3, 1)[:, None], (0, 0, 1, 1, 1, 1), mode="reflect")[:, 0].permute(0, 3, 1, 2)
    return F.pad(x, (1, 1, 1, 1), mode="reflect")


def normalize_image(x):
    """The reference's fixed input normalization (depth_encoder.py:396,
    resnet_encoder.py:126): (x - 0.45) / 0.225."""
    return (x - 0.45) / 0.225
