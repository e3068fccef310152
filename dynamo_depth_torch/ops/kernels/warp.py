"""Bilinear warp (``grid_sample`` with border padding, align_corners=True).

Kernels K1 ``warp_fwd`` and K2 ``warp_bwd`` in ``csrc/warp.cu`` replace the
TPU's ``_taps_kernel`` (``dynamo_depth_tpu/ops/pallas/warp_kernel.py``)
together with the coordinate math and lerp the JAX package ran around it.
:func:`grid_sample_plain` is the same function in plain PyTorch ops.

Semantics (``dynamo_depth_tpu/ops/warp.py:25-41``): unnormalize
``g = (grid + 1) / 2 * (size - 1)``, clamp the coordinate to
``[0, size - 1]``, origin ``floor`` clipped to ``[0, size - 2]``, lerp
weight ``g - origin`` (1 at the far border). The coordinate gradient is zero
where the clamp saturates and, as ``jnp.clip``'s, half where the coordinate
lies exactly on 0 or ``size - 1``.

The image may be float32 or bfloat16 (``--image_dtype``; grid and gradient
float32 either way): a bfloat16 image runs the bfloat16-operand instances
``warp_fwd_bf16``/``warp_bwd_bf16``, counted under those names, which read
bfloat16 taps and compute in float32 after them; the output and d_grid are
float32, d_image has the image's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_depth_torch.ops.kernels import build

LAUNCHES = {"warp_fwd": 0, "warp_bwd": 0, "warp_fwd_bf16": 0, "warp_bwd_bf16": 0}
_IMAGE_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}  # image dtype -> instance suffix


def _clip(u, hi):
    """``jnp.clip(u, 0, hi)`` with its gradient, 0.5 at either bound
    (``Tensor.clamp`` passes 1 there)."""
    return torch.minimum(torch.maximum(u, u.new_zeros(())), u.new_full((), hi))


def _coords(grid, H, W):
    gx = _clip((grid[..., 0] + 1.0) * 0.5 * (W - 1), W - 1)
    gy = _clip((grid[..., 1] + 1.0) * 0.5 * (H - 1), H - 1)
    x0 = torch.floor(gx).clamp(0, W - 2).detach()
    y0 = torch.floor(gy).clamp(0, H - 2).detach()
    return x0, y0, gx - x0, gy - y0


def grid_sample_plain(image, grid):
    """Plain PyTorch version: image ``(B, C, H, W)``, grid ``(B, Ho, Wo, 2)``
    -> ``(B, C, Ho, Wo)``. Differentiable in both arguments by autograd. A
    bfloat16 image is widened to float32 first, as the kernels widen its
    taps."""
    _check_shapes(image, grid)
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


def _check_shapes(image, grid):
    if image.dim() != 4 or grid.dim() != 4 or grid.shape[-1] != 2 or grid.shape[0] != image.shape[0]:
        raise ValueError(f"grid_sample wants image (B,C,H,W) and grid (B,Ho,Wo,2); got {tuple(image.shape)}, {tuple(grid.shape)}")
    if image.shape[2] < 2 or image.shape[3] < 2:
        raise ValueError(f"grid_sample needs H, W >= 2; got {tuple(image.shape)}")


def _check_cuda(image, grid, g_out=None):
    """Raise unless every tensor is a contiguous CUDA tensor on one device,
    the image float32 or bfloat16, the grid and the gradient float32; -> the
    instance's name suffix for the image's dtype."""
    tensors = {"image": image, "grid": grid, "gradient": g_out}
    for what, t in tensors.items():
        if t is None:
            continue
        dtypes = _IMAGE_DTYPES if what == "image" else (torch.float32,)
        if not t.is_cuda or t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(
                f"warp kernels take contiguous CUDA tensors: a float32 or bfloat16 image, a float32 grid and "
                f"gradient; got the {what} as {t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
    if len({t.device for t in tensors.values() if t is not None}) != 1:
        raise ValueError("warp kernel tensors must share one device")
    return _IMAGE_DTYPES[image.dtype]


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD, _BWD = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {"warp_fwd": _FWD, "warp_bwd": _BWD, "warp_fwd_bf16": _FWD, "warp_bwd_bf16": _BWD}


def _lib():
    return build.load("warp", _SIGNATURES)


def warp_fwd(image, grid):
    """K1: launch the forward kernel, the instance of the image's dtype.
    -> float32 ``(B, C, Ho, Wo)``."""
    _check_shapes(image, grid)
    name = "warp_fwd" + _check_cuda(image, grid)
    B, C, H, W = image.shape
    Ho, Wo = grid.shape[1], grid.shape[2]
    out = torch.empty((B, C, Ho, Wo), device=image.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(image.device).cuda_stream
    err = getattr(_lib(), name)(image.data_ptr(), grid.data_ptr(), out.data_ptr(), B, C, H, W, Ho, Wo, stream)
    build.check(err, name)
    LAUNCHES[name] += 1
    return out


def warp_bwd(image, grid, g_out, need_image_grad):
    """K2: launch the backward kernel, the instance of the image's dtype.
    -> (d_image in the image's dtype, or None; float32 d_grid)."""
    name = "warp_bwd" + _check_cuda(image, grid, g_out)
    B, C, H, W = image.shape
    Ho, Wo = grid.shape[1], grid.shape[2]
    if g_out.shape != (B, C, Ho, Wo):
        raise ValueError(f"warp_bwd: gradient shape {tuple(g_out.shape)} != {(B, C, Ho, Wo)}")
    d_grid = torch.empty_like(grid)
    # d_image is a float32 scatter-add target: it starts from zero.
    d_image = torch.zeros_like(image, dtype=torch.float32) if need_image_grad else None
    stream = torch.cuda.current_stream(image.device).cuda_stream
    err = getattr(_lib(), name)(
        image.data_ptr(), grid.data_ptr(), g_out.data_ptr(), d_grid.data_ptr(),
        d_image.data_ptr() if d_image is not None else None,
        B, C, H, W, Ho, Wo, stream,
    )
    build.check(err, name)
    LAUNCHES[name] += 1
    return (None if d_image is None else d_image.to(image.dtype)), d_grid


class _GridSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, grid):
        ctx.save_for_backward(image, grid)
        return warp_fwd(image, grid)

    @staticmethod
    def backward(ctx, g_out):
        image, grid = ctx.saved_tensors
        d_image, d_grid = warp_bwd(image, grid, g_out.contiguous(), ctx.needs_input_grad[0])
        return d_image, (d_grid if ctx.needs_input_grad[1] else None)


def grid_sample(image, grid):
    """Bilinear warp: K1/K2 for CUDA tensors, the plain version for CPU ones."""
    if image.is_cuda or grid.is_cuda:
        return _GridSample.apply(image.contiguous(), grid.contiguous())
    return grid_sample_plain(image, grid)
