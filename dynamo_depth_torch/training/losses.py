"""View synthesis + loss assembly (reference ``Trainer.py:215-461``), NCHW.

Port of ``dynamo_depth_tpu.training.losses``. Warping happens at full
resolution for every scale (disparity upsampled first), exactly as
Trainer.py:225-287, through ``ops.warp.grid_sample`` (CUDA kernels K1/K2 on
the card). The photometric error goes through ``ops.photometric.
reprojection_loss`` (K3/K4 on the card); the minimum over source frames, the
identity automask with tie-break noise, and the motion regularizers follow
Trainer.py:327-402.

Layouts: images and per-pixel maps are (B, C, H, W); sample grids are
(B, H, W, 2) and point clouds / flows (B, H*W, 3), as in the JAX package.

The warp's source image has the dtype ``cfg.image_dtype`` picks
(``config.warp_image_dtype``, the JAX package's ``_image_dtype``): bfloat16
taps, a float32 lerp and output. The photometric error stays float32
whatever it says, as in the JAX package (``losses.py:58-68``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from dynamo_depth_torch.config import warp_image_dtype
from dynamo_depth_torch.ops.geometry import backproject, depth_to_disp, disp_to_depth, project, unit_rays
from dynamo_depth_torch.ops.ground_plane import ground_plane_fit
from dynamo_depth_torch.ops.photometric import reprojection_loss, smooth_loss
from dynamo_depth_torch.ops.warp import grid_sample, resize_bilinear
from dynamo_depth_torch.utils.spans import span

LOSS_TERMS = ("p_photo", "d_smooth", "d_ground", "c_smooth", "c_consistency", "m_sparsity", "m_smooth")


def _nchw(flow, B, H, W):
    """(B, H*W, C) point-major -> (B, C, H, W)."""
    return flow.reshape(B, H, W, -1).permute(0, 3, 1, 2)


def _points(flow_map):
    """(B, C, H, W) -> (B, H*W, C)."""
    B, C, H, W = flow_map.shape
    return flow_map.permute(0, 2, 3, 1).reshape(B, H * W, C)


def loss_coefficients(cfg, step_in_phase, steps_per_epoch) -> Dict[str, float]:
    """Per-term coefficients with the weight ramp (Trainer.py:303-310):
    ramped coefficients scale by clip(ramp_red * step / steps_per_epoch, 0, 1)."""
    ramp = min(max(cfg.ramp_red * step_in_phase / steps_per_epoch, 0.0), 1.0)
    coefs = {}
    for term in LOSS_TERMS:
        c = float(getattr(cfg, "g_" + term))
        coefs[term] = c * ramp if ("g_" + term) in cfg.weight_ramp else c
    return coefs


def view_synthesis(cfg, inputs, outputs, *, bool_CmpFlow, bool_MotMask, automask, shards=1):
    """Warped reconstructions per (scale, source frame) (Trainer.py:215-287).
    Mutates and returns ``outputs``. Each source frame is cast once to the
    dtype ``warp_image_dtype(cfg, image, shards)`` picks, and warped at every
    scale; ``shards`` is 1 in the training step and the world size in
    validation and the visualisation (``warp_image_dtype`` says why)."""
    H, W = cfg.height, cfg.width
    K = inputs[("K", 0)]
    inv_K = inputs[("inv_K", 0)]
    sources = {}
    for f in cfg.frame_ids[1:]:
        image = inputs[("color", f, 0)]
        sources[f] = image.to(warp_image_dtype(cfg, image, shards))

    for scale in cfg.scales:
        disp_native = outputs[("disp", 0, scale)]
        disp = resize_bilinear(disp_native, (H, W))
        disp_scaled, depth = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
        outputs[("depth", 0, scale)] = depth
        outputs[("disp_scaled", 0, scale)] = disp_scaled

        cam_points = backproject(depth, inv_K)  # (B, H*W, 3)
        B = depth.shape[0]
        h, w = disp_native.shape[2], disp_native.shape[3]

        for f in cfg.frame_ids[1:]:
            T = outputs[("cam_T_cam", 0, f)]
            if bool_MotMask:
                mask_r = resize_bilinear(outputs[("motion_mask", f, scale)], (H, W))
            else:
                mask_r = torch.ones((B, 1, H, W), dtype=depth.dtype, device=depth.device)
            outputs[("motion_mask_r", f, scale)] = mask_r

            if bool_CmpFlow:
                sample_ego, ego_flow = project(cam_points, K, T, height=H, width=W)
                cflow = _points(resize_bilinear(outputs[("complete_flow", f, scale)], (H, W)))
                cflow = cflow * inputs[("ts", f)].reshape(B, 1, 1)
                residual_flow = cflow - ego_flow
                independ_flow = residual_flow * _points(mask_r)

                # Detached 2D samples for mask supervision (Trainer.py:255-260).
                outputs[("sample_ego", f, scale)] = sample_ego.detach()
                sample_complete, _ = project(cam_points.detach() + cflow, K, None, height=H, width=W)
                outputs[("sample_complete", f, scale)] = sample_complete.detach()

                if bool_MotMask:
                    sample, _ = project(cam_points + independ_flow, K, T, height=H, width=W)
                else:
                    sample, _ = project(cam_points + cflow, K, None, height=H, width=W)
            else:
                sample, ego_flow = project(cam_points, K, T, height=H, width=W)
                residual_flow = torch.zeros_like(ego_flow)
                independ_flow = torch.zeros_like(ego_flow)

            outputs[("sample", f, scale)] = sample
            outputs[("color", f, scale)] = grid_sample(sources[f], sample)
            outputs[("ego_flow", f, scale)] = ego_flow
            outputs[("independ_flow", f, scale)] = _nchw(independ_flow, B, H, W)
            outputs[("residual_flow", f, scale)] = resize_bilinear(_nchw(residual_flow, B, H, W), (h, w))
            if automask:
                outputs[("color_identity", f, scale)] = inputs[("color", f, 0)]
    return outputs


def draw_automask_noise(shape, generator, device):
    """Standard normal draws for the automask's tie-break noise (scaled by
    1e-5 by the caller), from ``generator``."""
    return torch.randn(shape, generator=generator, device=device)


def _bce_with_logits(logits, targets):
    """Elementwise BCEWithLogits (no reduction), with ``jnp.maximum``'s and
    ``jnp.abs``'s subgradients at logits == 0 (0.5 and 1)."""
    magnitude = torch.where(logits >= 0, logits, -logits)
    return torch.maximum(logits, torch.zeros_like(logits)) - logits * targets + torch.log1p(torch.exp(-magnitude))


def process_ground(cfg, inputs, outputs, scale, generator):
    """Ground-plane fit + below-ground disparity penalty terms
    (Trainer.py:425-461). Returns (plane_dist, disp_diff, g_mask), NCHW."""
    disp = outputs[("disp", 0, scale)]
    _, depth = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
    inv_K = inputs[("inv_K", scale)]
    B, _, h, w = disp.shape

    pts = backproject(depth, inv_K).reshape(B, h, w, 3)
    plane_dist, plane_param = ground_plane_fit(
        pts, generator,
        num_points_per_it=cfg.gp_np_per_it, max_it=cfg.gp_max_it,
        tol=cfg.gp_tol, g_prior=cfg.gp_prior, score_mode=cfg.gp_score_mode,
    )
    g_mask = (torch.abs(plane_dist) < cfg.gp_tol).to(disp.dtype)
    w1 = plane_param[:, 0]
    w2 = plane_param[:, 1]
    w3 = plane_param[:, 2] + cfg.gp_tol  # Trainer.py:437-438

    # Unit-depth rays v = inv_K @ pix (Trainer.py:452-457).
    rays = unit_rays(inv_K, h, w)
    vx, vy, vz = rays[..., 0], rays[..., 1], rays[..., 2]
    # NaN-safe division (double-where): a ray parallel to the fitted plane
    # gives denom ~ 0; 0/0 would leak NaN through the untaken branch.
    denom = vy - vx * w1 - vz * w2
    degenerate = torch.abs(denom) < 1e-12
    safe_denom = torch.where(degenerate, torch.ones_like(denom), denom)
    ground_depth = torch.where(degenerate, torch.full_like(denom, cfg.max_depth + 1.0), w3 / safe_denom)
    ground_depth = ground_depth.reshape(B, 1, h, w)
    # ~(x > 0) also catches NaN and exactly-0 depth.
    invalid = ~(ground_depth > 0) | (ground_depth > cfg.max_depth)
    ground_depth = torch.where(invalid, torch.full_like(ground_depth, cfg.max_depth), ground_depth)
    ground_disp = depth_to_disp(ground_depth, cfg.min_depth, cfg.max_depth)

    disp_diff = disp - ground_disp
    disp_diff = torch.where(ground_depth == cfg.max_depth, torch.zeros_like(disp_diff), disp_diff)
    return plane_dist, disp_diff, g_mask


def compute_losses(
    cfg,
    inputs,
    outputs,
    generator,
    *,
    bool_CmpFlow: bool,
    bool_MotMask: bool,
    automask: bool,
    trainable_networks: Tuple[str, ...],
    step_in_phase,
    steps_per_epoch: int,
) -> Dict[str, torch.Tensor]:
    """Assemble the total loss (Trainer.py:289-411). Returns a dict with
    'loss' plus per-term / per-coefficient scalars for logging. ``generator``
    drives the automask tie-break noise and the RANSAC draws."""
    move_Depth = "Depth" in trainable_networks
    move_CmpFlow = "CmpFlow" in trainable_networks
    move_MotMask = "MotMask" in trainable_networks

    sources = list(cfg.frame_ids[1:])
    num_frames = len(sources)
    target = inputs[("color", 0, 0)]
    dev = target.device

    def zero():
        return torch.zeros((), dtype=torch.float32, device=dev)

    coefs = loss_coefficients(cfg, step_in_phase, steps_per_epoch)
    losses: Dict[str, torch.Tensor] = {"loss": zero()}
    for term in LOSS_TERMS:
        losses[f"loss_term/{term}"] = zero()
        # A fill, not torch.tensor: that would be a blocking host-to-device copy.
        losses[f"loss_coef/{term}"] = torch.full((), coefs[term], dtype=torch.float32, device=dev)
    for scale in cfg.scales:
        losses[f"loss_term/{scale}"] = zero()

    for scale in cfg.scales:
        ps = {k: zero() for k in LOSS_TERMS}
        color_s = inputs[("color", 0, scale)]

        # --- photometric with min over sources (+ identity automask) -------
        reproj = torch.cat(
            [reprojection_loss(outputs[("color", f, scale)], target, ssim_weight=cfg.ssim_weight) for f in sources],
            dim=1,
        )  # (B, F, H, W)
        if automask:
            identity = torch.cat(
                [reprojection_loss(inputs[("color", f, 0)], target, ssim_weight=cfg.ssim_weight) for f in sources],
                dim=1,
            )
            noise = draw_automask_noise(identity.shape, generator, dev) * 1e-5
            combined = torch.cat([identity + noise, reproj], dim=1)
        else:
            combined = reproj

        if combined.shape[1] == 1:
            to_optimise = combined[:, 0]
        else:
            # amin, as jnp.min, splits the gradient evenly among tied sources.
            to_optimise = torch.amin(combined, dim=1)
            if automask:
                idxs = torch.argmin(combined, dim=1)
                outputs[f"identity_selection/{scale}"] = (idxs > identity.shape[1] - 1).float()
        ps["p_photo"] = torch.mean(to_optimise)

        # --- disparity regularization --------------------------------------
        if move_Depth:
            disp = outputs[("disp", 0, scale)]
            if cfg.g_d_smooth > 0:
                norm_disp = disp / (torch.mean(disp, dim=(2, 3), keepdim=True) + 1e-7)
                ps["d_smooth"] = smooth_loss(norm_disp, color_s) / (2 ** scale)
            if cfg.g_d_ground > 0 and bool_MotMask:
                with span("dynamo.ground_plane"):
                    _, disp_diff, _ = process_ground(cfg, inputs, outputs, scale, generator)
                disp_diff = torch.minimum(disp_diff, torch.zeros_like(disp_diff))  # below ground is negative
                ps["d_ground"] = -1.0 * torch.mean(disp_diff) / (2 ** scale)

        # --- motion regularization -----------------------------------------
        for f in sources:
            disp = outputs[("disp", 0, scale)]
            motion_mask = outputs.get(("motion_mask", f, scale))
            h, w = disp.shape[2], disp.shape[3]

            if move_CmpFlow and bool_CmpFlow:
                complete_flow = outputs[("complete_flow", f, scale)]
                residual_flow = outputs[("residual_flow", f, scale)]
                if cfg.g_c_smooth > 0:
                    ps["c_smooth"] = ps["c_smooth"] + smooth_loss(complete_flow, color_s) / (2 ** scale) / num_frames
                if bool_MotMask and cfg.g_c_consistency > 0:
                    valid_disp = (disp > cfg.mask_disp_thrd).to(disp.dtype).detach()
                    mask_det = motion_mask.detach()
                    # |residual_flow| with jnp.abs's subgradient, 1 at 0.
                    ps["c_consistency"] = ps["c_consistency"] + (
                        torch.mean(valid_disp * (1 - mask_det) * torch.where(residual_flow >= 0, residual_flow, -residual_flow))
                        / (2 ** scale) / num_frames
                    )

            if move_MotMask and bool_MotMask:
                if cfg.g_m_sparsity > 0:
                    sample_ego = resize_bilinear(outputs[("sample_ego", f, scale)].permute(0, 3, 1, 2), (h, w))
                    sample_complete = resize_bilinear(outputs[("sample_complete", f, scale)].permute(0, 3, 1, 2), (h, w))
                    disp_mag = torch.sum((sample_ego - sample_complete) ** 2, dim=1)  # (B, h, w)
                    static = disp_mag < torch.mean(disp_mag)  # global batch mean (Trainer.py:397)
                    motion_prob = outputs[("motion_prob", f, scale)][:, 0]
                    all_have_static = torch.all(static.sum(dim=(1, 2)) > 0)
                    bce = _bce_with_logits(motion_prob, torch.zeros_like(motion_prob))
                    masked_mean = torch.sum(torch.where(static, bce, torch.zeros_like(bce))) / torch.clamp(
                        static.sum().float(), min=1.0
                    )
                    ps["m_sparsity"] = ps["m_sparsity"] + torch.where(
                        all_have_static, masked_mean, torch.zeros_like(masked_mean)
                    ) / (2 ** scale) / num_frames
                if cfg.g_m_smooth > 0:
                    ps["m_smooth"] = ps["m_smooth"] + smooth_loss(motion_mask, color_s) / (2 ** scale) / num_frames

        # --- compile (Trainer.py:404-409) ----------------------------------
        for term in LOSS_TERMS:
            losses[f"loss_term/{scale}"] = losses[f"loss_term/{scale}"] + ps[term] * coefs[term]
            losses[f"loss_term/{term}"] = losses[f"loss_term/{term}"] + ps[term]
        losses["loss"] = losses["loss"] + losses[f"loss_term/{scale}"] / len(cfg.scales)

    return losses
