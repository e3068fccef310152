"""Bilinear warping (grid_sample) and image resizing, NCHW.

``grid_sample`` reproduces ``F.grid_sample(..., padding_mode='border',
align_corners=True)`` (``Trainer.py:281``), values and both gradients; on the
card it runs the CUDA kernels K1/K2 and on the CPU their plain version
(``ops/kernels/warp.py``). ``resize_bilinear`` is ``F.interpolate(mode=
'bilinear', align_corners=False)``, computed for factors that are not whole
numbers as the JAX package computes it; ``resize_bicubic_aa`` reproduces
``jax.image.resize(..., 'bicubic', antialias=True)`` plus a clip to [0, 1],
the colour pyramid of the JAX package (``Trainer.py:729-734``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from dynamo_depth_torch.ops.kernels.warp import grid_sample  # noqa: F401


def _whole_factor(n, m):
    return n % m == 0 or m % n == 0


def _src_coords(out_n, in_n, like):
    """Left source index and weight of each output row (or column), in the
    JAX package's float32 operations."""
    d = torch.arange(out_n, dtype=like.dtype, device=like.device)
    s = ((d + 0.5) * (in_n / out_n) - 0.5).clamp(0.0, in_n - 1)
    i0 = torch.floor(s).clamp(0, max(in_n - 2, 0))
    return i0.long(), s - i0


def resize_bilinear(x, out_hw):
    """``F.interpolate(mode='bilinear', align_corners=False)`` for NCHW.

    Whole-number factors (the networks' and the losses' 2x and 4x) run
    ``F.interpolate``. Other factors (the eval CLIs' upsampling to a
    dataset's full resolution) take the JAX package's separable gather, row
    pass then column pass, operation for operation: ``F.interpolate`` rounds
    the float32 source coordinates otherwise, and on a random image its
    values then differ from the JAX package's by up to 1.5e-5 at 192x640 ->
    375x1242, 1280x1920 and 900x1600.
    """
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
    """Keys cubic kernel with a = -0.5 on |distance| (jax.image's CUBIC)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


@functools.lru_cache(maxsize=32)
def _aa_cubic_weights(in_n: int, out_n: int, device: str):
    """(in_n, out_n) antialiased bicubic weights, built in float32 the way
    ``jax.image.scale_and_translate`` builds them (``compute_weight_mat``):
    the kernel is widened by 1/scale when downsampling, every column is
    normalized by its sum, and samples outside the input are zeroed."""
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
    """Antialiased bicubic resize of NCHW, clamped to [0, 1]."""
    H, W = x.shape[-2:]
    Ho, Wo = out_hw
    if (Ho, Wo) == (H, W):
        return x
    wh = _aa_cubic_weights(H, Ho, str(x.device)).to(x.dtype)  # (H, Ho)
    ww = _aa_cubic_weights(W, Wo, str(x.device)).to(x.dtype)  # (W, Wo)
    out = torch.matmul(wh.t(), torch.matmul(x, ww))
    return torch.clamp(out, 0.0, 1.0)
