"""Warping, resizing and the photometric error in plain PyTorch, NCHW.

Frozen copies of the program's plain versions: ``grid_sample`` is
``F.grid_sample(..., padding_mode='border', align_corners=True)`` with
``jnp.clip``'s gradient at the clamp (the CUDA kernels K1/K2 replace it in
the program); ``reprojection_loss`` is SSIM + L1 (K3/K4 in the program);
``resize_bilinear``, ``upsample2x_nearest`` and ``resize_bicubic_aa`` (the
colour pyramid) are the program's resizes; ``smooth_loss`` is the
edge-aware smoothness.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

# ------------------------------------------------------------------ warp


def _clip(u, hi):
    """``jnp.clip(u, 0, hi)`` with its gradient, 0.5 at either bound."""
    return torch.minimum(torch.maximum(u, u.new_zeros(())), u.new_full((), hi))


def _coords(grid, H, W):
    gx = _clip((grid[..., 0] + 1.0) * 0.5 * (W - 1), W - 1)
    gy = _clip((grid[..., 1] + 1.0) * 0.5 * (H - 1), H - 1)
    x0 = torch.floor(gx).clamp(0, W - 2).detach()
    y0 = torch.floor(gy).clamp(0, H - 2).detach()
    return x0, y0, gx - x0, gy - y0


def grid_sample(image, grid):
    """Bilinear warp: image ``(B, C, H, W)``, grid ``(B, Ho, Wo, 2)`` ->
    ``(B, C, Ho, Wo)`` float32. A bfloat16 image is widened to float32
    first. Differentiable in both arguments by autograd."""
    if image.dtype == torch.bfloat16:
        image = image.float()
    B, C, H, W = image.shape
    Ho, Wo = grid.shape[1], grid.shape[2]
    x0, y0, wx, wy = _coords(grid, H, W)
    idx = (y0 * W + x0).long().reshape(B, 1, Ho * Wo).expand(B, C, Ho * Wo)
    flat = image.reshape(B, C, H * W)

    def tap(offset):
        return flat.gather(2, idx + offset).reshape(B, C, Ho, Wo)

    v00, v01, v10, v11 = tap(0), tap(1), tap(W), tap(W + 1)
    wx = wx[:, None]
    wy = wy[:, None]
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    return top + (bot - top) * wy


# ----------------------------------------------------------- photometric

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _avg_pool3x3(x):
    """3x3/stride-1 mean pool, VALID, as separable shifted adds."""
    r = x[:, :, :-2] + x[:, :, 1:-1] + x[:, :, 2:]
    return (r[..., :-2] + r[..., 1:-1] + r[..., 2:]) / 9.0


def ssim(x, y):
    """Per-pixel SSIM distance clip((1 - SSIM) / 2, 0, 1), NCHW, reflect-padded
    3x3 windows (tools.py:227-257)."""
    x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    y = F.pad(y, (1, 1, 1, 1), mode="reflect")
    mu_x = _avg_pool3x3(x)
    mu_y = _avg_pool3x3(y)
    sigma_x = _avg_pool3x3(x * x) - mu_x * mu_x
    sigma_y = _avg_pool3x3(y * y) - mu_y * mu_y
    sigma_xy = _avg_pool3x3(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    den = (mu_x * mu_x + mu_y * mu_y + C1) * (sigma_x + sigma_y + C2)
    return torch.clamp((1.0 - num / den) / 2.0, 0.0, 1.0)


def reprojection_loss(pred, target, *, ssim_weight=0.85):
    """Per-pixel photometric error ``(B, 1, H, W)``: w * mean_c SSIM + (1 - w)
    * mean_c L1. The L1 takes ``jnp.abs``'s subgradient 1 at 0."""
    d = target - pred
    l1 = torch.mean(torch.where(d >= 0, d, -d), dim=1, keepdim=True)
    ssim_term = torch.mean(ssim(pred, target), dim=1, keepdim=True)
    return ssim_weight * ssim_term + (1.0 - ssim_weight) * l1


def smooth_loss(inp, img=None):
    """Edge-aware first-order smoothness for ``(B, C, H, W)`` (tools.py:311-326).
    |.| of ``inp``'s differences takes ``jnp.abs``'s subgradient 1 at 0."""
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


# ---------------------------------------------------------------- resize


def _whole_factor(n, m):
    return n % m == 0 or m % n == 0


def _src_coords(out_n, in_n, like):
    d = torch.arange(out_n, dtype=like.dtype, device=like.device)
    s = ((d + 0.5) * (in_n / out_n) - 0.5).clamp(0.0, in_n - 1)
    i0 = torch.floor(s).clamp(0, max(in_n - 2, 0))
    return i0.long(), s - i0


def resize_bilinear(x, out_hw):
    """``F.interpolate(mode='bilinear', align_corners=False)`` for NCHW;
    factors that are not whole numbers by a separable gather in float32."""
    H, W = x.shape[-2:]
    Ho, Wo = out_hw
    if (Ho, Wo) == (H, W):
        return x
    if _whole_factor(H, Ho) and _whole_factor(W, Wo):
        return F.interpolate(x, size=(Ho, Wo), mode="bilinear", align_corners=False)
    y0, wy = _src_coords(Ho, H, x)
    x0, wx = _src_coords(Wo, W, x)
    rows = x[..., y0, :] * (1 - wy)[:, None] + x[..., y0 + 1, :] * wy[:, None]
    return rows[..., x0] * (1 - wx) + rows[..., x0 + 1] * wx


def upsample2x_nearest(x):
    """x2 nearest upsample of NCHW (the Monodepth2 decoder's upsample)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _keys_cubic(x):
    """Keys cubic kernel with a = -0.5 on |distance|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


@functools.lru_cache(maxsize=32)
def _aa_cubic_weights(in_n: int, out_n: int, device: str):
    """(in_n, out_n) antialiased bicubic weights in float32: the kernel
    widened by 1/scale when downsampling, every column normalized by its
    sum, samples outside the input zeroed."""
    inv_scale = 1.0 / (out_n / in_n)
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    sample_f = (torch.arange(out_n, **f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_n, **f32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    eps = float(torch.finfo(torch.float32).eps)
    w = torch.where(torch.abs(total) > 1000.0 * eps, w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_n - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bicubic_aa(x, out_hw):
    """Antialiased bicubic resize of NCHW, clamped to [0, 1] (the colour
    pyramid)."""
    H, W = x.shape[-2:]
    Ho, Wo = out_hw
    if (Ho, Wo) == (H, W):
        return x
    wh = _aa_cubic_weights(H, Ho, str(x.device)).to(x.dtype)
    ww = _aa_cubic_weights(W, Wo, str(x.device)).to(x.dtype)
    out = torch.matmul(wh.t(), torch.matmul(x, ww))
    return torch.clamp(out, 0.0, 1.0)
