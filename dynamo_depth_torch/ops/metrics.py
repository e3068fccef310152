"""Sparse LiDAR-point depth evaluation metrics (port of
``dynamo_depth_tpu.ops.metrics``; reference ``DepthMetrics``, ``tools.py:6-73``,
and ``compute_errors``, ``tools.py:269-288``).

As in the JAX package, the disparity map is not resized to the ground
truth's resolution: the same bilinear interpolation (align_corners=False) is
evaluated at the LiDAR points only, so any ground-truth size gives the same
shapes. The per-sample loop of the reference is a batch dimension here, and
masked medians take ``torch.median``'s lower middle element. The optional
per-label breakdown takes mask labels already sampled at the points.
"""

from __future__ import annotations

import torch

DEPTH_METRIC_NAMES = ("de:abs_rel", "de:sq_rel", "de:rms", "de:log_rms", "da:a1", "da:a2", "da:a3")


def compute_errors(gt, pred, valid=None):
    """The 7 standard depth metrics over (optionally masked) point sets,
    along the last axis.

    :param gt, pred: ``(..., N)`` depths
    :param valid:    optional ``(..., N)`` boolean mask
    :return: (metrics ``(..., 7)`` in DEPTH_METRIC_NAMES order, count ``(...)``)
    """
    if valid is None:
        valid = torch.ones_like(gt, dtype=torch.bool)
    cnt = valid.to(gt.dtype).sum(-1)
    denom = cnt.clamp(min=1.0)

    def vmean(x):
        return torch.where(valid, x, torch.zeros_like(x)).sum(-1) / denom

    one = torch.ones_like(gt)
    safe_pred = torch.where(valid, pred, one)
    safe_gt = torch.where(valid, gt, one)

    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
    a1 = vmean((thresh < 1.25).to(gt.dtype))
    a2 = vmean((thresh < 1.25 ** 2).to(gt.dtype))
    a3 = vmean((thresh < 1.25 ** 3).to(gt.dtype))

    rmse = torch.sqrt(vmean((safe_gt - safe_pred) ** 2))
    rmse_log = torch.sqrt(vmean((torch.log(safe_gt) - torch.log(safe_pred)) ** 2))
    abs_rel = vmean(torch.abs(safe_gt - safe_pred) / safe_gt)
    sq_rel = vmean((safe_gt - safe_pred) ** 2 / safe_gt)
    return torch.stack([abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3], dim=-1), cnt


def _masked_median_lower(x, valid):
    """torch.median semantics (lower middle element) over the valid entries
    of the last axis."""
    big = torch.full_like(x, torch.finfo(x.dtype).max)
    xs = torch.sort(torch.where(valid, x, big), dim=-1).values
    k = (valid.sum(-1) - 1).clamp(min=0) // 2
    return xs.gather(-1, k[..., None])[..., 0]


def _sample_bilinear_at(disp, ys, xs, gt_h, gt_w):
    """bilinear-resize(disp -> (gt_h, gt_w), align_corners=False) evaluated at
    the integer output pixels (floor(ys), floor(xs)), without the resized map.

    disp: ``(B, H, W)``; ys, xs: ``(B, N)``; gt_h, gt_w: ``(B, 1)`` float.
    """
    B, H, W = disp.shape
    yi, xi = torch.floor(ys), torch.floor(xs)
    sy = ((yi + 0.5) * (H / gt_h) - 0.5).clamp(0.0, H - 1)
    sx = ((xi + 0.5) * (W / gt_w) - 0.5).clamp(0.0, W - 1)
    y0 = torch.floor(sy).clamp(0, H - 2)
    x0 = torch.floor(sx).clamp(0, W - 2)
    wy, wx = sy - y0, sx - x0
    y0, x0 = y0.long(), x0.long()
    flat = disp.reshape(B, H * W)

    def g(yy, xx):
        return flat.gather(1, yy * W + xx)

    top = g(y0, x0) * (1 - wx) + g(y0, x0 + 1) * wx
    bot = g(y0 + 1, x0) * (1 - wx) + g(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def depth_metrics(
    disp_pred,
    depth_gt,
    depth_valid,
    gt_dim,
    img_bound,
    *,
    min_depth=1e-3,
    max_depth=80.0,
    mask_pts=None,
    labels=None,
    sample_weight=None,
):
    """Batched sparse-point depth metrics.

    :param disp_pred:   ``(B, 1, H, W)`` scaled disparity (1/depth) at scale 0
    :param depth_gt:    ``(B, N, 3)`` padded LiDAR points [h, w, z]
    :param depth_valid: ``(B, N)`` 1 for real points, 0 for padding
    :param gt_dim:      ``(B, 2)`` ground-truth image dims [h, w]
    :param img_bound:   ``(4,)`` [top, bottom, left, right] fractional bounds
    :param mask_pts:    optional ``(B, N)`` integer mask labels at the points
    :param labels:      labels for the per-class breakdown
    :return: dict with the 7 batch-mean metrics (0-d tensors); when labels
             are given, also ``'<metric>_mask/<label>'`` -> (sum(metric*cnt), sum(cnt)).
    """
    disp = disp_pred[:, 0].float()
    dev = disp.device
    depth_gt = torch.as_tensor(depth_gt, dtype=torch.float32, device=dev)
    depth_valid = torch.as_tensor(depth_valid, device=dev)
    gt_dim = torch.as_tensor(gt_dim, device=dev).float()
    img_bound = torch.as_tensor(img_bound, dtype=torch.float32, device=dev)

    gt_h, gt_w = gt_dim[:, 0:1], gt_dim[:, 1:2]
    # int() truncation in the reference == floor for non-negative bounds.
    up, down = torch.floor(img_bound[0] * gt_h), torch.floor(img_bound[1] * gt_h)
    left, right = torch.floor(img_bound[2] * gt_w), torch.floor(img_bound[3] * gt_w)
    h_pt, w_pt, z_pt = depth_gt[..., 0], depth_gt[..., 1], depth_gt[..., 2]
    valid = (
        (depth_valid > 0)
        & (h_pt >= up) & (h_pt < down)
        & (w_pt >= left) & (w_pt < right)
        & (z_pt > min_depth) & (z_pt < max_depth)
    )

    disp_at = _sample_bilinear_at(disp, h_pt, w_pt, gt_h, gt_w)
    d_pd = 1.0 / disp_at.clamp(min=1e-12)
    d_gt = z_pt
    ratio = _masked_median_lower(d_gt, valid) / _masked_median_lower(d_pd, valid)
    d_pd = (d_pd * ratio[:, None]).clamp(min_depth, max_depth)

    per_sample, _ = compute_errors(d_gt, d_pd, valid)  # (B, 7)
    if sample_weight is None:
        sample_weight = torch.ones((disp.shape[0],), dtype=torch.float32, device=dev)
    sample_weight = torch.as_tensor(sample_weight, dtype=torch.float32, device=dev)
    w = sample_weight / sample_weight.sum().clamp(min=1.0)
    out = {name: (per_sample[:, i] * w).sum() for i, name in enumerate(DEPTH_METRIC_NAMES)}

    if labels is not None:
        if mask_pts is None:
            raise ValueError("labels need mask_pts")
        mask_pts = torch.as_tensor(mask_pts, device=dev)
        for lbl in labels:
            sel = valid & (mask_pts == lbl) & (sample_weight > 0)[:, None]
            m, cnt = compute_errors(d_gt, d_pd, sel)  # (B, 7), (B,)
            for i, name in enumerate(DEPTH_METRIC_NAMES):
                out[f"{name}_mask/{lbl}"] = ((m[:, i] * cnt).sum(), cnt.sum())
    return out
