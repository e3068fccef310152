"""The port's gradients at exact ties against the JAX package, on the CPU.

At a tie PyTorch and JAX pick different subgradients: ``jnp.abs`` passes 1
at 0 (``torch.abs`` 0), ``jnp.clip``, ``jnp.minimum`` and ``jnp.maximum``
pass 0.5 at a bound (``torch.clamp`` 1), and ``jnp.min`` over an axis splits
the gradient evenly among tied entries (``torch.min(dim)`` gives all of it
to one). Each test puts such a tie where a gradient flows and holds the
port to the JAX package there. The L1 term of the photometric error is held
at pred == target in ``test_torch_kernel_tiles.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.ops import photometric as tp
from dynamo_depth_torch.ops import warp as tw
from dynamo_depth_torch.training import losses as tl
from dynamo_depth_torch.utils.layout import nchw_to_nhwc, nhwc_to_nchw
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.ops import photometric as jp
from dynamo_depth_tpu.ops import warp as jw
from dynamo_depth_tpu.ops.pallas import grid_sample_pallas
from dynamo_depth_tpu.training import losses as jl

B, H, W = 1, 6, 8


@pytest.mark.parametrize("with_img", [True, False])
def test_smooth_loss_where_neighbours_are_equal(rng, with_img):
    # Values on a coarse lattice: about a third of the neighbouring pairs tie.
    inp = (rng.randint(0, 3, (2, H, W, 1)) * 0.5).astype(np.float32)
    img = rng.rand(2, H, W, 3).astype(np.float32)
    assert (inp[:, :, 1:] == inp[:, :, :-1]).mean() > 0.2
    d_ref = jax.grad(lambda x: jp.smooth_loss(x, jnp.asarray(img) if with_img else None))(jnp.asarray(inp))
    x = torch.tensor(nhwc_to_nchw(inp), requires_grad=True)
    tp.smooth_loss(x, torch.tensor(nhwc_to_nchw(img)) if with_img else None).backward()
    np.testing.assert_allclose(nchw_to_nhwc(x.grad.numpy()), np.asarray(d_ref), atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("jax_fn", [jw.grid_sample, grid_sample_pallas], ids=["xla", "pallas"])
def test_grid_sample_where_the_grid_is_exactly_on_the_border(rng, jax_fn):
    C = 3
    img = rng.rand(B, H, W, C).astype(np.float32)
    # Clipped to [-1, 1]: ~1/6 of the entries per axis are exactly -1 or 1,
    # where the unnormalized coordinate is exactly 0 or size - 1.
    grid = np.clip(rng.rand(B, H, W, 2) * 2.4 - 1.2, -1.0, 1.0).astype(np.float32)
    g = rng.randn(B, H, W, C).astype(np.float32)
    assert (np.abs(grid) == 1.0).mean() > 0.1
    d_grid_ref = jax.grad(lambda gr: jnp.sum(jax_fn(jnp.asarray(img), gr) * g))(jnp.asarray(grid))
    gr = torch.tensor(grid, requires_grad=True)
    (tw.grid_sample(torch.tensor(nhwc_to_nchw(img)), gr) * torch.tensor(nhwc_to_nchw(g))).sum().backward()
    np.testing.assert_allclose(gr.grad.numpy(), np.asarray(d_grid_ref), atol=2e-5, rtol=1e-5)


def _configs(**kw):
    kw = dict(dataset="kitti", height=H, width=W, batch_size=B, weights_init="scratch", scales=[0], **kw)
    return JConfig(**kw), TConfig(**kw)


def _loss_grads(jcfg, tcfg, inputs, outputs, wrt, **flags):
    """d loss / d outputs[k] for k in ``wrt``: (JAX, port), both NHWC.
    ``inputs`` and ``outputs`` hold NHWC numpy arrays."""

    def jax_loss(vals):
        outs = {**{k: jnp.asarray(v) for k, v in outputs.items()}, **dict(zip(wrt, vals))}
        ins = {k: jnp.asarray(v) for k, v in inputs.items()}
        return jl.compute_losses(jcfg, ins, outs, jax.random.PRNGKey(0), step_in_phase=0, steps_per_epoch=1, **flags)["loss"]

    ref = jax.grad(jax_loss)([jnp.asarray(outputs[k]) for k in wrt])
    outs = {k: torch.tensor(nhwc_to_nchw(v), requires_grad=k in wrt) for k, v in outputs.items()}
    ins = {k: torch.tensor(nhwc_to_nchw(v)) for k, v in inputs.items()}
    loss = tl.compute_losses(tcfg, ins, outs, torch.Generator().manual_seed(0), step_in_phase=0, steps_per_epoch=1, **flags)["loss"]
    got = torch.autograd.grad(loss, [outs[k] for k in wrt])
    return [np.asarray(r) for r in ref], [nchw_to_nhwc(t.numpy()) for t in got]


def test_photometric_minimum_where_two_sources_tie(rng):
    jcfg, tcfg = _configs()
    target = rng.rand(B, H, W, 3).astype(np.float32)
    warped = rng.rand(B, H, W, 3).astype(np.float32)
    # Both warped sources are the same image: their errors tie at every pixel.
    outputs = {("color", -1, 0): warped, ("color", 1, 0): warped.copy(),
               ("disp", 0, 0): rng.rand(B, H, W, 1).astype(np.float32)}
    inputs = {("color", 0, 0): target}
    ref, got = _loss_grads(
        jcfg, tcfg, inputs, outputs, [("color", -1, 0), ("color", 1, 0)],
        bool_CmpFlow=False, bool_MotMask=False, automask=False, trainable_networks=(),
    )
    for r, g in zip(ref, got):
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(g, r, atol=1e-7, rtol=1e-5)


def test_ground_penalty_where_the_disparity_meets_the_ground(rng, monkeypatch):
    jcfg, tcfg = _configs(g_d_smooth=0.0)
    disp = rng.rand(B, H, W, 1).astype(np.float32)
    # The fitted ground's disparity: equal to disp at a third of the pixels,
    # above it (below ground: penalized) at a third, under it at the rest.
    offset = rng.choice(np.array([0.0, 0.1, -0.1], np.float32), size=disp.shape)
    ground = disp + offset
    assert (ground == disp).mean() > 0.2
    monkeypatch.setattr(jl, "process_ground", lambda cfg, inputs, outputs, scale, rng: (
        None, outputs[("disp", 0, scale)] - jnp.asarray(ground), None))
    monkeypatch.setattr(tl, "process_ground", lambda cfg, inputs, outputs, scale, gen: (
        None, outputs[("disp", 0, scale)] - torch.tensor(nhwc_to_nchw(ground)), None))
    outputs = {("disp", 0, 0): disp, ("color", -1, 0): rng.rand(B, H, W, 3).astype(np.float32),
               ("color", 1, 0): rng.rand(B, H, W, 3).astype(np.float32)}
    inputs = {("color", 0, 0): rng.rand(B, H, W, 3).astype(np.float32)}
    (ref,), (got,) = _loss_grads(
        jcfg, tcfg, inputs, outputs, [("disp", 0, 0)],
        bool_CmpFlow=False, bool_MotMask=True, automask=False, trainable_networks=("Depth",),
    )
    np.testing.assert_allclose(got, ref, atol=1e-9, rtol=1e-6)


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_with_logits_at_zero_logits(rng, target):
    logits = rng.randn(4, 5).astype(np.float32)
    logits[rng.rand(4, 5) < 0.4] = 0.0
    targets = np.full_like(logits, target)
    ref, d_ref = jax.value_and_grad(lambda x: jnp.sum(jl._bce_with_logits(x, jnp.asarray(targets))))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    out = tl._bce_with_logits(x, torch.tensor(targets)).sum()
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(d_ref), atol=1e-7, rtol=1e-6)


def test_c_consistency_where_residual_flow_is_zero(rng):
    # Only the consistency term: no ramp, no smoothness of the flow.
    jcfg, tcfg = _configs(weight_ramp=[], g_c_smooth=0.0)
    residual = rng.randn(B, H, W, 3).astype(np.float32)
    residual[rng.rand(B, H, W, 3) < 0.4] = 0.0
    outputs = {("disp", 0, 0): rng.rand(B, H, W, 1).astype(np.float32)}
    for f in (-1, 1):
        outputs[("color", f, 0)] = rng.rand(B, H, W, 3).astype(np.float32)
        outputs[("motion_mask", f, 0)] = rng.rand(B, H, W, 1).astype(np.float32)
        outputs[("complete_flow", f, 0)] = rng.randn(B, H, W, 3).astype(np.float32)
        outputs[("residual_flow", f, 0)] = residual if f == -1 else -residual
    inputs = {("color", 0, 0): rng.rand(B, H, W, 3).astype(np.float32)}
    ref, got = _loss_grads(
        jcfg, tcfg, inputs, outputs, [("residual_flow", -1, 0), ("residual_flow", 1, 0)],
        bool_CmpFlow=True, bool_MotMask=True, automask=False, trainable_networks=("CmpFlow",),
    )
    for r, g in zip(ref, got):
        assert np.abs(r[residual == 0]).max() > 0
        np.testing.assert_allclose(g, r, atol=1e-9, rtol=1e-6)
