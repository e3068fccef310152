"""The port's photometric ops against the JAX package, on the CPU.

The port's ``reprojection_loss`` takes its plain PyTorch version for CPU
tensors; the JAX side runs both its XLA formulation and the fused Pallas
kernel (``reprojection_loss_fused``, in interpret mode on the CPU).
Random inputs keep away from exact ties; the gradients at pred == target
are held in ``test_torch_kernel_tiles.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch.ops import photometric as tp
from dynamo_depth_torch.ops.kernels import launch_counts, reset_launch_counts
from dynamo_depth_torch.utils.layout import nchw_to_nhwc, nhwc_to_nchw
from dynamo_depth_tpu.ops import photometric as jp
from dynamo_depth_tpu.ops.pallas import reprojection_loss_fused

# float32 window sums taken in another order; SSIM ratios amplify that by a
# few, hence 1e-5 on values in [0, 1].
VAL_ATOL = 1e-5
GRAD_ATOL = 1e-5


def _fused(p, t):
    return reprojection_loss_fused(p, t, 0.85)


def _xla(p, t):
    return jp.reprojection_loss(p, t, ssim_weight=0.85)


@pytest.mark.parametrize("jax_fn", [_xla, _fused], ids=["xla", "pallas"])
@pytest.mark.parametrize("shape", [(2, 10, 12, 3), (1, 4, 4, 3), (2, 7, 5, 2)], ids=["10x12", "4x4", "7x5"])
def test_reprojection_loss_values_and_grads(rng, jax_fn, shape):
    pred = rng.rand(*shape).astype(np.float32)
    target = rng.rand(*shape).astype(np.float32)
    B, H, W, _ = shape
    g = rng.randn(B, H, W, 1).astype(np.float32)

    ref = np.asarray(jax_fn(jnp.asarray(pred), jnp.asarray(target)))
    d_pred_ref, d_target_ref = jax.grad(lambda p, t: jnp.sum(jax_fn(p, t) * g), argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(target)
    )

    reset_launch_counts()
    p = torch.tensor(nhwc_to_nchw(pred), requires_grad=True)
    t = torch.tensor(nhwc_to_nchw(target), requires_grad=True)
    out = tp.reprojection_loss(p, t, ssim_weight=0.85)
    (out * torch.tensor(nhwc_to_nchw(g))).sum().backward()

    assert out.shape == (B, 1, H, W)
    np.testing.assert_allclose(nchw_to_nhwc(out.detach().numpy()), ref, atol=VAL_ATOL, rtol=0)
    # 4x4: every pixel sits within one of a reflected border, so the
    # transposed stencil's extra border terms are all exercised.
    np.testing.assert_allclose(nchw_to_nhwc(p.grad.numpy()), np.asarray(d_pred_ref), atol=GRAD_ATOL, rtol=1e-4)
    np.testing.assert_allclose(nchw_to_nhwc(t.grad.numpy()), np.asarray(d_target_ref), atol=GRAD_ATOL, rtol=1e-4)
    assert all(v == 0 for v in launch_counts().values())


def test_ssim(rng):
    x = rng.rand(2, 9, 11, 3).astype(np.float32)
    y = rng.rand(2, 9, 11, 3).astype(np.float32)
    ref = np.asarray(jp.ssim(jnp.asarray(x), jnp.asarray(y)))
    out = tp.ssim(torch.tensor(nhwc_to_nchw(x)), torch.tensor(nhwc_to_nchw(y)))
    np.testing.assert_allclose(nchw_to_nhwc(out.numpy()), ref, atol=VAL_ATOL, rtol=0)


@pytest.mark.parametrize("with_img", [True, False])
def test_smooth_loss(rng, with_img):
    inp = rng.rand(2, 8, 10, 3).astype(np.float32)
    img = rng.rand(2, 8, 10, 3).astype(np.float32)
    ref = jp.smooth_loss(jnp.asarray(inp), jnp.asarray(img) if with_img else None)
    d_ref = jax.grad(lambda x: jp.smooth_loss(x, jnp.asarray(img) if with_img else None))(jnp.asarray(inp))
    x = torch.tensor(nhwc_to_nchw(inp), requires_grad=True)
    out = tp.smooth_loss(x, torch.tensor(nhwc_to_nchw(img)) if with_img else None)
    out.backward()
    # A mean of ~500 float32 terms: relative round-off ~1e-6.
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(nchw_to_nhwc(x.grad.numpy()), np.asarray(d_ref), atol=1e-7, rtol=1e-5)
