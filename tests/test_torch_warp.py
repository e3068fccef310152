"""The port's warp and resize ops against the JAX package, on the CPU.

The port's ``grid_sample`` takes its plain PyTorch version for CPU tensors;
the JAX side runs both its XLA formulation and the Pallas kernel
(``grid_sample_pallas``, in interpret mode on the CPU). Inputs are NHWC
numpy arrays from a seeded RandomState, transposed to NCHW for the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch.ops import warp as tw
from dynamo_depth_torch.ops.kernels import launch_counts, reset_launch_counts
from dynamo_depth_torch.utils.layout import nchw_to_nhwc, nhwc_to_nchw
from dynamo_depth_tpu.ops import warp as jw
from dynamo_depth_tpu.ops.pallas import grid_sample_pallas

# float32 lerp arithmetic in a different order: a few ulps of values in [0, 1].
VAL_ATOL = 1e-5
# Gradients are sums of a handful of such products; d_grid carries the
# (size - 1) / 2 unnormalize factor, hence the relative term.
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-5


def _port_grid_sample(img, grid, g):
    im = torch.tensor(nhwc_to_nchw(img), requires_grad=True)
    gr = torch.tensor(grid, requires_grad=True)
    out = tw.grid_sample(im, gr)
    (out * torch.tensor(nhwc_to_nchw(g))).sum().backward()
    return nchw_to_nhwc(out.detach().numpy()), nchw_to_nhwc(im.grad.numpy()), gr.grad.numpy()


@pytest.mark.parametrize("jax_fn", [jw.grid_sample, grid_sample_pallas], ids=["xla", "pallas"])
# (B, H, W, C, Ho, Wo): the last three at the edges of the card kernels'
# tiles (2-pixel pairs on 64x4 output tiles forward, 32x8 backward): Wo one
# past a backward tile with Ho not a multiple of 4, Wo one past a forward
# tile, two channels.
@pytest.mark.parametrize("shape", [
    (2, 9, 13, 3, 7, 11), (1, 6, 5, 3, 12, 10), (2, 4, 4, 2, 4, 4),
    (1, 9, 40, 3, 5, 33), (1, 6, 70, 3, 3, 65), (2, 7, 9, 2, 6, 10),
])
def test_grid_sample_values_and_grads(rng, jax_fn, shape):
    B, H, W, C, Ho, Wo = shape
    img = rng.rand(B, H, W, C).astype(np.float32)
    # [-1.2, 1.2] puts ~1/6 of the samples outside the image on each axis, so
    # the border clamp and its zero coordinate gradient are exercised.
    grid = (rng.rand(B, Ho, Wo, 2) * 2.4 - 1.2).astype(np.float32)
    g = rng.randn(B, Ho, Wo, C).astype(np.float32)

    def loss(im, gr):
        return jnp.sum(jax_fn(im, gr) * g)

    ref = np.asarray(jax_fn(jnp.asarray(img), jnp.asarray(grid)))
    d_img_ref, d_grid_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(grid))

    reset_launch_counts()
    out, d_img, d_grid = _port_grid_sample(img, grid, g)
    np.testing.assert_allclose(out, ref, atol=VAL_ATOL, rtol=0)
    np.testing.assert_allclose(d_img, np.asarray(d_img_ref), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    np.testing.assert_allclose(d_grid, np.asarray(d_grid_ref), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    outside = np.abs(grid) > 1.0
    assert outside.any() and np.all(d_grid[outside] == 0.0)
    assert all(v == 0 for v in launch_counts().values())  # CPU tensors take the plain path


@pytest.mark.parametrize(
    "in_hw,out_hw",
    [((6, 10), (12, 20)), ((12, 20), (6, 10)), ((12, 20), (4, 5)), ((7, 9), (10, 4)), ((1, 1), (6, 8))],
    ids=["up2", "down2", "down_int", "general", "from_1x1"],
)
def test_resize_bilinear(rng, in_hw, out_hw):
    x = rng.rand(2, *in_hw, 3).astype(np.float32)
    ref = np.asarray(jw.resize_bilinear(jnp.asarray(x), out_hw))
    out = nchw_to_nhwc(tw.resize_bilinear(torch.tensor(nhwc_to_nchw(x)), out_hw).numpy())
    # Interpolation weights computed in another order: a few ulps.
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("in_hw,out_hw", [((32, 64), (16, 32)), ((16, 32), (8, 16)), ((24, 40), (10, 17))])
def test_resize_bicubic_aa(rng, in_hw, out_hw):
    x = rng.rand(2, *in_hw, 3).astype(np.float32)
    ref = np.asarray(jw.resize_bicubic_aa(jnp.asarray(x), out_hw))
    out = nchw_to_nhwc(tw.resize_bicubic_aa(torch.tensor(nhwc_to_nchw(x)), out_hw).numpy())
    # Same float32 weight matrices as jax.image; contraction order differs.
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_upsample2x_nearest(rng):
    x = rng.rand(2, 5, 7, 4).astype(np.float32)
    ref = np.asarray(jw.upsample2x_nearest(jnp.asarray(x)))
    out = nchw_to_nhwc(tw.upsample2x_nearest(torch.tensor(nhwc_to_nchw(x))).numpy())
    np.testing.assert_array_equal(out, ref)
