"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without an NVIDIA card (a CUDA kernel
has no CPU mode). On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Shapes are chosen for the edges of the kernels' tiling: widths that are not
multiples of the tiles (64 for K1 and K4, 32 for K2, K3's 30-column warp
bands) or of K1's and K2's 2-pixel and K4's 16-byte vectors, one pixel past
a tile (33, 65), heights not multiples of K1's 4-row and K2's 8-row tiles,
K3's 8-row strips, K4's 16-row tile or its 4-row strips, the smallest images
(2 and 3 pixels, where every pixel is a reflected border), one to four
channels (K2 has an unrolled instance for three and a generic one for the
others). K2 also runs
at the main path's size on the ego-motion grid, and with its grid and
gradient 4 bytes off 16-byte alignment, where it takes scalar accesses. K1
is also run on grids at both ends of locality: near the identity
(neighbouring pixels share taps), the ego-motion stand-in
``training/synthetic.py::ego_motion_grid``, and uniform over the image (every
tap in its own cache sector).

At exact ties the kernels take the JAX package's subgradients, as the plain
versions do: K2 passes half the coordinate gradient where a grid entry is
exactly -1 or 1, K4 the L1 subgradient of ``jnp.abs`` where pred equals
target. Both are held here on inputs with such ties.
"""

import pytest
import torch
import torch.nn.functional as F

from dynamo_depth_torch.ops.kernels import launch_counts, photometric, reset_launch_counts, warp
from dynamo_depth_torch.training.synthetic import ego_motion_grid

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _scale_tol(ref, rel):
    return rel * max(1.0, float(ref.abs().max()))


def _misaligned(t):
    """``t``'s values in a contiguous view 4 bytes past 16-byte alignment."""
    buf = torch.empty(t.numel() + 4, device=t.device, dtype=t.dtype)
    view = buf[1:1 + t.numel()].view_as(t)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("border", ["beyond", "on"])
@pytest.mark.parametrize("shape,kind", [
    ((2, 3, 9, 13, 7, 11), "uniform"), ((1, 3, 2, 2, 5, 3), "uniform"), ((2, 1, 37, 70, 37, 70), "uniform"),
    ((1, 4, 8, 32, 16, 64), "uniform"), ((1, 3, 3, 3, 3, 3), "uniform"), ((2, 4, 17, 67, 17, 67), "uniform"),
    ((1, 1, 20, 130, 9, 65), "uniform"), ((1, 3, 24, 64, 24, 128), "uniform"),
    ((1, 3, 9, 40, 5, 33), "uniform"), ((1, 3, 20, 70, 6, 65), "uniform"), ((2, 2, 16, 40, 10, 34), "uniform"),
    ((3, 3, 192, 640, 192, 640), "ego"), ((2, 3, 16, 48, 8, 64), "misaligned"),
])
def test_warp_kernels_match_plain(dev, shape, kind, border):
    B, C, H, W, Ho, Wo = shape
    g = torch.Generator(device=dev).manual_seed(0)
    img = torch.rand(B, C, H, W, device=dev, generator=g, requires_grad=True)
    if kind == "ego":
        grid = ego_motion_grid(B, Ho, Wo, seed=0).to(dev)
    else:  # [-1.2, 1.2]: ~1/6 of the entries per axis lie beyond the border
        grid = torch.rand(B, Ho, Wo, 2, device=dev, generator=g) * 2.4 - 1.2
    if border == "on":  # clipped to [-1, 1]: those entries lie exactly on it
        grid = grid.clamp(-1.0, 1.0)
    grid.requires_grad_()
    cot = torch.randn(B, C, Ho, Wo, device=dev, generator=g)

    reset_launch_counts()
    out = warp.grid_sample(img, grid)
    d_img, d_grid = torch.autograd.grad(out, (img, grid), cot)
    assert launch_counts()["warp_fwd"] == 1 and launch_counts()["warp_bwd"] == 1
    out_p = warp.grid_sample_plain(img, grid)
    d_img_p, d_grid_p = torch.autograd.grad(out_p, (img, grid), cot)
    # float32 lerps with and without fused multiply-adds; d_image summed by
    # atomics in no fixed order.
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(d_img, d_img_p, rtol=0, atol=_scale_tol(d_img_p, 1e-5))
    torch.testing.assert_close(d_grid, d_grid_p, rtol=0, atol=_scale_tol(d_grid_p, 1e-5))

    # The image needs no gradient: the kernel skips d_image.
    out2 = warp.grid_sample(img.detach(), grid)
    (d_grid2,) = torch.autograd.grad(out2, grid, cot)
    torch.testing.assert_close(d_grid2, d_grid_p, rtol=0, atol=_scale_tol(d_grid_p, 1e-5))

    # K2 called directly, with and without d_image, on the grid and gradient
    # as given (misaligned: 4 bytes off 16-byte alignment).
    grid_k, cot_k = grid.detach(), cot
    if kind == "misaligned":
        grid_k, cot_k = _misaligned(grid_k), _misaligned(cot_k)
    for need_image_grad in (True, False):
        d_img_k, d_grid_k = warp.warp_bwd(img.detach(), grid_k, cot_k, need_image_grad)
        torch.testing.assert_close(d_grid_k, d_grid_p, rtol=0, atol=_scale_tol(d_grid_p, 1e-5))
        if need_image_grad:
            torch.testing.assert_close(d_img_k, d_img_p, rtol=0, atol=_scale_tol(d_img_p, 1e-5))


def _grid(kind, B, H, W, Ho, Wo, dev, g):
    """A sample grid over an (H, W) image: ``near_identity`` (each output
    pixel samples within ~1.5 px of the same place, rescaled to the source),
    ``uniform`` (anywhere in [-1.1, 1.1]) or ``ego`` (``ego_motion_grid``)."""
    if kind == "ego":
        return ego_motion_grid(B, Ho, Wo, seed=3).to(dev)
    if kind == "uniform":
        return torch.rand(B, Ho, Wo, 2, device=dev, generator=g) * 2.2 - 1.1
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, Ho, device=dev), torch.linspace(-1, 1, Wo, device=dev), indexing="ij")
    base = torch.stack([xs, ys], -1).expand(B, Ho, Wo, 2)
    jitter = (torch.rand(B, Ho, Wo, 2, device=dev, generator=g) * 2 - 1) * 1.5
    return base + jitter * 2 / torch.tensor([W - 1, H - 1], device=dev)


@pytest.mark.parametrize("kind,shape", [
    ("near_identity", (2, 3, 48, 80, 48, 80)),
    ("near_identity", (1, 4, 37, 70, 37, 70)),
    ("uniform", (2, 3, 48, 80, 48, 80)),
    ("uniform", (1, 4, 37, 70, 37, 70)),
    ("ego", (3, 3, 192, 640, 192, 640)),
])
def test_warp_fwd_on_near_and_far_grids_matches_plain_and_grid_sample(dev, kind, shape):
    B, C, H, W, Ho, Wo = shape
    g = torch.Generator(device=dev).manual_seed(2)
    img = torch.rand(B, C, H, W, device=dev, generator=g)
    grid = _grid(kind, B, H, W, Ho, Wo, dev, g)

    out = warp.warp_fwd(img, grid)
    out_p = warp.grid_sample_plain(img, grid)
    out_l = F.grid_sample(img, grid, mode="bilinear", padding_mode="border", align_corners=True)
    # float32 lerps with and without fused multiply-adds.
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, out_l, rtol=0, atol=1e-5)


@pytest.mark.parametrize("target_is", ["random", "pred"])
@pytest.mark.parametrize("shape", [
    (2, 3, 10, 12), (1, 3, 4, 4), (1, 3, 2, 2), (2, 1, 37, 70), (1, 3, 192, 640),
    (1, 3, 3, 3), (1, 4, 2, 2), (2, 4, 17, 67), (1, 1, 18, 66), (1, 3, 33, 130), (1, 3, 16, 64),
    (1, 1, 3, 3), (1, 4, 9, 31), (2, 1, 25, 61), (1, 3, 41, 91), (1, 4, 7, 120),
])
def test_photometric_kernels_match_plain(dev, shape, target_is):
    g = torch.Generator(device=dev).manual_seed(1)
    pred = torch.rand(*shape, device=dev, generator=g, requires_grad=True)
    target = torch.rand(*shape, device=dev, generator=g, requires_grad=True)
    if target_is == "pred":  # a textured image against itself: the L1 term at its tie
        target = pred.detach().clone().requires_grad_()
    cot = torch.randn(shape[0], 1, shape[2], shape[3], device=dev, generator=g)

    reset_launch_counts()
    out = photometric.reprojection_loss(pred, target, 0.85)
    d_pred, d_target = torch.autograd.grad(out, (pred, target), cot)
    assert launch_counts()["photometric_fwd"] == 1 and launch_counts()["photometric_bwd"] == 1
    out_p = photometric.reprojection_loss_plain(pred, target, 0.85)
    d_pred_p, d_target_p = torch.autograd.grad(out_p, (pred, target), cot)
    # Window sums in another order, amplified by the SSIM ratios.
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(d_pred, d_pred_p, rtol=0, atol=_scale_tol(d_pred_p, 1e-4))
    torch.testing.assert_close(d_target, d_target_p, rtol=0, atol=_scale_tol(d_target_p, 1e-4))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.rand(1, 3, 6, 8, device=dev)
    with pytest.raises(ValueError):
        warp.warp_fwd(x.double(), torch.rand(1, 5, 7, 2, device=dev))
    # bfloat16 too: the bfloat16 step casts the networks' outputs to float32
    # before view synthesis, and the wrappers do not cast.
    with pytest.raises(ValueError, match="float32"):
        warp.warp_fwd(x.bfloat16(), torch.rand(1, 5, 7, 2, device=dev))
    with pytest.raises(ValueError, match="float32"):
        warp.warp_bwd(x, torch.rand(1, 5, 7, 2, device=dev), torch.rand(1, 3, 5, 7, device=dev).bfloat16(), True)
    with pytest.raises(ValueError, match="float32"):
        photometric.photometric_fwd(x.bfloat16(), x.bfloat16(), 0.85)
    with pytest.raises(ValueError, match="float32"):
        photometric.photometric_bwd(x, x, torch.rand(1, 1, 6, 8, device=dev).bfloat16(), 0.85, True)
    with pytest.raises(ValueError):
        photometric.photometric_fwd(x[..., ::2], x[..., ::2], 0.85)  # not contiguous
    with pytest.raises(ValueError):
        photometric.photometric_fwd(x, torch.rand(1, 3, 6, 9, device=dev), 0.85)
