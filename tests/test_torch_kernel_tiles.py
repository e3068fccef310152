"""What surrounds the redesigned kernels, on the CPU.

K1 and K2 are timed on ``training/synthetic.py::ego_motion_grid``, a
stand-in for a trained model's ego-motion, so the grid is checked for the
displacement it stands for and the warp is held to the JAX package on it.
Where pred equals target the L1 term takes ``jnp.abs``'s subgradient 1 at 0
in the port too; the SSIM clip's edge s = 0 moves nothing there, since the
SSIM gradient vanishes where the windows are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch.ops import photometric as tp
from dynamo_depth_torch.ops import warp as tw
from dynamo_depth_torch.ops.geometry import pixel_grid
from dynamo_depth_torch.training.synthetic import ego_motion_grid
from dynamo_depth_torch.utils.layout import nchw_to_nhwc, nhwc_to_nchw
from dynamo_depth_tpu.ops import photometric as jp
from dynamo_depth_tpu.ops import warp as jw

@pytest.mark.parametrize("B,H,W,seed", [(2, 64, 192, 0), (1, 192, 640, 0), (3, 37, 70, 5)])
def test_ego_motion_grid_is_a_smooth_ego_motion(B, H, W, seed):
    grid = ego_motion_grid(B, H, W, seed=seed)
    assert grid.shape == (B, H, W, 2) and grid.dtype == torch.float32
    assert torch.equal(grid, ego_motion_grid(B, H, W, seed=seed))
    px = (grid + 1) * 0.5 * torch.tensor([W - 1.0, H - 1.0])
    shift = (px - pixel_grid(H, W)[:, :2].reshape(1, H, W, 2)).norm(dim=-1)
    # A few to a few tens of pixels (~1 m forward at 5-80 m, small yaw),
    # growing with the image: the largest shift is ~0.14 of its width.
    assert 0.5 < float(shift.median()) < 0.05 * W and float(shift.max()) < 0.3 * W
    # Smooth: neighbouring pixels move alike, to ~1/300 of the width.
    assert float((shift[:, :, 1:] - shift[:, :, :-1]).abs().max()) < 0.01 * W


@pytest.mark.parametrize("B,H,W,C,seed", [(2, 24, 80, 3, 1), (1, 37, 70, 4, 2)])
def test_warp_on_the_main_path_grid_matches_jax(rng, B, H, W, C, seed):
    grid = ego_motion_grid(B, H, W, seed=seed).numpy()
    img = rng.rand(B, H, W, C).astype(np.float32)
    g = rng.randn(B, H, W, C).astype(np.float32)
    ref = np.asarray(jw.grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    d_grid_ref = jax.grad(lambda gr: jnp.sum(jw.grid_sample(jnp.asarray(img), gr) * g))(jnp.asarray(grid))

    gr = torch.tensor(grid, requires_grad=True)
    out = tw.grid_sample(torch.tensor(nhwc_to_nchw(img)), gr)
    (out * torch.tensor(nhwc_to_nchw(g))).sum().backward()
    np.testing.assert_allclose(nchw_to_nhwc(out.detach().numpy()), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gr.grad.numpy(), np.asarray(d_grid_ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("flat", [False, True], ids=["random", "flat"])
def test_photometric_gradient_where_pred_equals_target(rng, flat):
    B, H, W, C = 1, 6, 7, 3
    pred = np.full((B, H, W, C), 0.5, np.float32) if flat else rng.rand(B, H, W, C).astype(np.float32)
    g = rng.randn(B, H, W, 1).astype(np.float32)
    d_ref = jax.grad(lambda p: jnp.sum(jp.reprojection_loss(p, jnp.asarray(pred), ssim_weight=0.85) * g))(
        jnp.asarray(pred)
    )
    p = torch.tensor(nhwc_to_nchw(pred), requires_grad=True)
    out = tp.reprojection_loss(p, torch.tensor(nhwc_to_nchw(pred)), ssim_weight=0.85)
    (out * torch.tensor(nhwc_to_nchw(g))).sum().backward()
    # The SSIM term is ~0 on both sides, whatever the clip passes at s = 0;
    # the L1 term, -(1 - w) / C * g on both, is what the comparison holds.
    assert np.abs(np.asarray(d_ref)).max() > 0.01
    np.testing.assert_allclose(nchw_to_nhwc(p.grad.numpy()), np.asarray(d_ref), atol=1e-5, rtol=0)
