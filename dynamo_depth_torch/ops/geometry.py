"""Projective geometry + SE(3) ops (port of ``dynamo_depth_tpu.ops.geometry``).

Point clouds are carried points-last as ``(B, N, 3)``, as in the JAX package;
depth maps come in NCHW ``(B, 1, H, W)`` (or ``(B, H, W)``). Every
contraction here feeds sub-pixel sample coordinates, so the products run in
true float32: they are written as broadcast multiply-adds over the tiny 3x3
and 4x4 camera matrices, which never route through TF32 tensor cores
whatever ``torch.backends.cuda.matmul.allow_tf32`` says (the JAX package
pins ``Precision.HIGHEST`` for the same reason).
"""

from __future__ import annotations

import functools

import torch


def disp_to_depth(disp, min_depth, max_depth):
    """Sigmoid disparity in [0, 1] -> (scaled_disp, depth) (tools.py:291-298)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    depth = 1.0 / scaled_disp
    return scaled_disp, depth


def depth_to_disp(depth, min_depth, max_depth):
    """Inverse of :func:`disp_to_depth` (tools.py:301-308)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = 1.0 / depth
    return (scaled_disp - min_disp) / (max_disp - min_disp)


def _bmv(M, p):
    """Exact-fp32 ``einsum('bij,bnj->bni', M, p)`` for 3x3 ``M``."""
    return (
        M[:, None, :, 0] * p[..., 0:1]
        + M[:, None, :, 1] * p[..., 1:2]
        + M[:, None, :, 2] * p[..., 2:3]
    )


def _bmm4(A, B):
    """Exact-fp32 batched product of (B, 4, 4) matrices."""
    return (A[:, :, :, None] * B[:, None, :, :]).sum(dim=2)


def rot_from_axisangle(vec):
    """Axis-angle ``(B, 3)`` -> rotation matrices ``(B, 4, 4)`` (Rodrigues,
    layers.py:43-82, including the 1e-7 guard on the angle norm)."""
    angle = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)  # (B, 1)
    axis = vec / (angle + 1e-7)

    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    C = 1.0 - ca

    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC

    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    rot = torch.stack(
        [
            x * xC + ca, xyC - zs,    zxC + ys,    zeros,
            xyC + zs,    y * yC + ca, yzC - xs,    zeros,
            zxC - ys,    yzC + xs,    z * zC + ca, zeros,
            zeros,       zeros,       zeros,       ones,
        ],
        dim=-1,
    )
    return rot.reshape(vec.shape[0], 4, 4)


def translation_matrix(t):
    """Translation ``(B, 3)`` -> homogeneous ``(B, 4, 4)`` (layers.py:27-40)."""
    B = t.shape[0]
    eye = torch.eye(4, dtype=t.dtype, device=t.device).expand(B, 4, 4)
    col = torch.cat([t, torch.ones_like(t[:, :1])], dim=1)  # (B, 4)
    return torch.cat([eye[:, :, :3], col[:, :, None]], dim=2)


def transformation_from_parameters(axisangle, translation, invert=False):
    """(axis-angle ``(B,3)``, translation ``(B,3)``) -> SE(3) ``(B,4,4)``.

    ``invert=False``: M = T(t) @ R.  ``invert=True``: M = R^T @ T(-t)
    (layers.py:7-24).
    """
    R = rot_from_axisangle(axisangle)
    if invert:
        return _bmm4(R.transpose(1, 2), translation_matrix(-translation))
    return _bmm4(translation_matrix(translation), R)


def pixel_grid(height: int, width: int, device=None, dtype=torch.float32):
    """Homogeneous pixel coordinates ``(H*W, 3)`` = [x, y, 1], row-major over
    (y, x) as tools.py:177-189."""
    ys, xs = torch.meshgrid(
        torch.arange(height, device=device, dtype=dtype),
        torch.arange(width, device=device, dtype=dtype),
        indexing="ij",
    )
    return torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones(height * width, device=device, dtype=dtype)], -1)


def unit_rays(inv_K, height: int, width: int):
    """``inv_K[:3, :3] @ [x, y, 1]`` for every pixel: ``(B, H*W, 3)``."""
    pix = pixel_grid(height, width, inv_K.device, inv_K.dtype)
    return _bmv(inv_K[:, :3, :3], pix[None].expand(inv_K.shape[0], -1, -1))


def backproject(depth, inv_K):
    """Depth map ``(B, 1, H, W)`` or ``(B, H, W)`` -> camera-frame points
    ``(B, H*W, 3)`` (tools.py:191-197, without the homogeneous ones row)."""
    if depth.dim() == 4:
        depth = depth[:, 0]
    B, H, W = depth.shape
    return unit_rays(inv_K, H, W) * depth.reshape(B, H * W, 1)


@functools.lru_cache(maxsize=32)
def _pixel_scale(width: int, height: int, dtype: torch.dtype, device: torch.device):
    """The divisor ``[width - 1, height - 1]`` of :func:`project`, built once
    per size, dtype and device: a fresh one is a blocking host-to-device copy
    on every call. Built outside inference mode, so that autograd may save it
    whichever mode the first caller ran in."""
    with torch.inference_mode(False):
        return torch.tensor([width - 1, height - 1], dtype=dtype, device=device)


def project(points, K, T=None, *, height, width, eps=1e-7):
    """Project camera-frame points to normalized sample coords + ego-flow.

    :param points: ``(B, N, 3)`` with N = height*width
    :param K:      ``(B, 4, 4)``
    :param T:      optional ``(B, 4, 4)`` camera motion applied before K
    :return: (pix_coords ``(B, H, W, 2)`` in [-1, 1] for ``grid_sample``,
              flow ``(B, N, 3)`` = T·p − p)

    Matches tools.py:211-224: pinhole division with +eps, normalization by
    (dim − 1) then mapping to [-1, 1].
    """
    B, N, _ = points.shape
    if height * width != N:
        raise ValueError(f"{N} points do not fill a {height}x{width} grid")
    moved = points if T is None else _bmv(T[:, :3, :3], points) + T[:, None, :3, 3]
    uvw = _bmv(K[:, :3, :3], moved) + K[:, None, :3, 3]

    pix = uvw[..., :2] / (uvw[..., 2:3] + eps)
    # True division by a tensor, not by Python scalars: CUDA divides by a
    # scalar as a product with its reciprocal, which can move the last bit.
    pix = pix / _pixel_scale(width, height, pix.dtype, pix.device)
    pix = (pix - 0.5) * 2.0
    return pix.reshape(B, height, width, 2), moved - points
