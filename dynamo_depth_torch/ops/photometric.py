"""Photometric losses: SSIM, reprojection (SSIM+L1), edge-aware smoothness.

Port of ``dynamo_depth_tpu.ops.photometric`` in NCHW. ``reprojection_loss``
runs the fused CUDA kernels K3/K4 on the card and their plain version on the
CPU (``ops/kernels/photometric.py``).
"""

from __future__ import annotations

import torch

from dynamo_depth_torch.ops.kernels.photometric import reprojection_loss as _reprojection_loss
from dynamo_depth_torch.ops.kernels.photometric import ssim_plain as ssim  # noqa: F401


def reprojection_loss(pred, target, *, ssim_weight=0.85):
    """Per-pixel photometric error ``(B, 1, H, W)``: w*SSIM + (1-w)*L1, each
    channel-meaned (Trainer.py:413-423)."""
    return _reprojection_loss(pred, target, ssim_weight)


def smooth_loss(inp, img=None):
    """Edge-aware first-order smoothness for ``(B, C, H, W)`` (tools.py:311-326).

    When ``img`` is given, gradients are attenuated by exp(-|∇img|) with the
    image gradient channel-meaned. |·| of ``inp``'s differences takes
    ``jnp.abs``'s subgradient 1 at 0 (``torch.abs`` takes 0).
    """
    dx = inp[..., :-1] - inp[..., 1:]
    dy = inp[..., :-1, :] - inp[..., 1:, :]
    gx = torch.where(dx >= 0, dx, -dx)
    gy = torch.where(dy >= 0, dy, -dy)
    if img is not None:
        igx = torch.mean(torch.abs(img[..., :-1] - img[..., 1:]), dim=1, keepdim=True)
        igy = torch.mean(torch.abs(img[..., :-1, :] - img[..., 1:, :]), dim=1, keepdim=True)
        gx = gx * torch.exp(-igx)
        gy = gy * torch.exp(-igy)
    return torch.mean(gx) + torch.mean(gy)
