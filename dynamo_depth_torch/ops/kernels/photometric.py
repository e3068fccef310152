"""Fused SSIM + L1 photometric error ``(B, C, H, W) x2 -> (B, 1, H, W)``.

Kernels K3 ``photometric_fwd`` and K4 ``photometric_bwd`` in
``csrc/photometric.cu`` replace the TPU's ``_kernel`` / ``_mean3x3_roll``
(``dynamo_depth_tpu/ops/pallas/photometric_kernel.py``) with the channel mean
and the L1 blend around them; K4 is a backward written by hand. The plain
PyTorch version is :func:`reprojection_loss_plain`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dynamo_depth_torch.ops.kernels import build

LAUNCHES = {"photometric_fwd": 0, "photometric_bwd": 0}

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _avg_pool3x3(x):
    """3x3/stride-1 mean pool, VALID, as separable shifted adds."""
    r = x[:, :, :-2] + x[:, :, 1:-1] + x[:, :, 2:]
    return (r[..., :-2] + r[..., 1:-1] + r[..., 2:]) / 9.0


def ssim_plain(x, y):
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


def reprojection_loss_plain(pred, target, ssim_weight=0.85):
    """Plain PyTorch version: w * mean_c SSIM + (1 - w) * mean_c L1. The L1
    takes ``jnp.abs``'s subgradient 1 at 0 (``torch.abs`` takes 0)."""
    d = target - pred
    l1 = torch.mean(torch.where(d >= 0, d, -d), dim=1, keepdim=True)
    ssim_term = torch.mean(ssim_plain(pred, target), dim=1, keepdim=True)
    return ssim_weight * ssim_term + (1.0 - ssim_weight) * l1


def _check(*tensors):
    shape = tensors[0].shape
    if len(shape) != 4 or shape[2] < 2 or shape[3] < 2:
        raise ValueError(f"photometric kernels take (B, C, H, W) with H, W >= 2; got {tuple(shape)}")
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"photometric kernels take contiguous float32 CUDA tensors; got {t.dtype} on {t.device}")
        if t.device != tensors[0].device:
            raise ValueError("photometric kernel tensors must share one device")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "photometric_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "photometric_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}


def _lib():
    return build.load("photometric", _SIGNATURES)


def photometric_fwd(pred, target, ssim_weight):
    """K3: launch the forward kernel. -> ``(B, 1, H, W)``."""
    _check(pred, target)
    if pred.shape != target.shape:
        raise ValueError(f"pred {tuple(pred.shape)} and target {tuple(target.shape)} differ")
    B, C, H, W = pred.shape
    out = torch.empty((B, 1, H, W), device=pred.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(pred.device).cuda_stream
    err = _lib().photometric_fwd(pred.data_ptr(), target.data_ptr(), out.data_ptr(), B, C, H, W, ssim_weight, stream)
    build.check(err, "photometric_fwd")
    LAUNCHES["photometric_fwd"] += 1
    return out


def photometric_bwd(pred, target, g_out, ssim_weight, need_target_grad):
    """K4: launch the backward kernel. -> (d_pred, d_target or None)."""
    _check(pred, target, g_out)
    B, C, H, W = pred.shape
    if g_out.shape != (B, 1, H, W):
        raise ValueError(f"photometric_bwd: gradient shape {tuple(g_out.shape)} != {(B, 1, H, W)}")
    d_pred = torch.empty_like(pred)
    d_target = torch.empty_like(target) if need_target_grad else None
    stream = torch.cuda.current_stream(pred.device).cuda_stream
    err = _lib().photometric_bwd(
        pred.data_ptr(), target.data_ptr(), g_out.data_ptr(), d_pred.data_ptr(),
        d_target.data_ptr() if d_target is not None else None,
        B, C, H, W, ssim_weight, stream,
    )
    build.check(err, "photometric_bwd")
    LAUNCHES["photometric_bwd"] += 1
    return d_pred, d_target


class _ReprojectionLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, ssim_weight):
        ctx.save_for_backward(pred, target)
        ctx.ssim_weight = ssim_weight
        return photometric_fwd(pred, target, ssim_weight)

    @staticmethod
    def backward(ctx, g_out):
        pred, target = ctx.saved_tensors
        d_pred, d_target = photometric_bwd(pred, target, g_out.contiguous(), ctx.ssim_weight, ctx.needs_input_grad[1])
        return (d_pred if ctx.needs_input_grad[0] else None), d_target, None


def reprojection_loss(pred, target, ssim_weight=0.85):
    """Photometric error: K3/K4 for CUDA tensors, the plain version for CPU ones."""
    if pred.is_cuda or target.is_cuda:
        return _ReprojectionLoss.apply(pred.contiguous(), target.contiguous(), float(ssim_weight))
    return reprojection_loss_plain(pred, target, ssim_weight)
