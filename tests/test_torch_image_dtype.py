"""``--image_dtype`` in the port against the JAX package, on the CPU: the
port's counterpart of ``tests/test_image_dtype.py``.

The JAX package casts the warp's source image to bfloat16 under
``image_dtype="bfloat16"``, and under ``auto`` from ``7 * 2**17`` pixels per
device (``training/losses.py::_image_dtype``); its warp then lerps bfloat16
taps into a float32 output. The port casts the same image and warps it
through K1/K2's bfloat16 instances on the card, through the plain version
here (the image widened to float32 first): "taps rounded, every operation
after them in float32".

How far JAX is from that definition depends on XLA. ``v01 - v00`` of two
bfloat16 taps is a bfloat16 operation in the jaxpr; with
``xla_allow_excess_precision`` on (XLA's default, and how the JAX package's
steps are compiled) the CPU compiler keeps it in float32. Measured on the
CPU at 2x16x24 on a random grid (``python tests/test_torch_image_dtype.py``
prints the gaps): values 1.2e-7 from the port's definition
and d_grid 1.9e-6 (of d_grid up to 35), against 1.9e-3 and 7.3e-2 for the
parent's float32-only path. With it off the difference is rounded to
bfloat16: values 1.7e-3 and d_grid 6.1e-2 from the definition, as far as
the float32 path. So the port is held to the default JAX warp at
``VAL_ATOL`` and ``GRAD_RTOL`` (8x and 18x the measured gaps), which the
float32 path misses by four orders of magnitude, and JAX without excess
precision is held to the bound its rounding gives (``ROUNDED_ATOL``).
Inputs are NHWC numpy arrays from a seeded RandomState, NCHW for the port.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch.config import DynamoConfig as TConfig, warp_image_dtype
from dynamo_depth_torch.ops.kernels import warp as t_warp
from dynamo_depth_torch.training import losses as t_losses
from dynamo_depth_torch.utils.layout import nchw_to_nhwc, nhwc_to_nchw
from dynamo_depth_torch.models.model import MODULE_NAMES
from dynamo_depth_torch.training.synthetic import synthetic_batch
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.models.convert import convert_module
from dynamo_depth_tpu.ops.pallas import grid_sample_pallas
from dynamo_depth_tpu.training.losses import _grid_sample, _image_dtype
import test_torch_train_step as train_step_tests
from test_torch_train_step import KW
from torch_test_threads import two_torch_threads  # noqa: F401

# The port's bfloat16 warp against JAX's with excess precision on (measured
# 1.2e-7 and 1.9e-6 / 35 = 5.5e-8 of the d_grid scale).
VAL_ATOL, GRAD_RTOL = 1e-6, 1e-6
# JAX with the tap differences rounded to bfloat16: each of the two row
# lerps is off by at most 2**-9 of a difference in [-1, 1] (measured 1.7e-3);
# d_grid by that fraction of its scale (measured 1.7e-3).
ROUNDED_ATOL, ROUNDED_GRAD_RTOL = 2 * 2**-9, 2**-8
B, H, W, C, HO, WO = 2, 16, 24, 3, 12, 20


def _jcfg(mode):
    return JConfig(dataset="kitti", image_dtype=mode, no_train_vis=True)


def _tcfg(mode):
    return TConfig(dataset="kitti", image_dtype=mode, no_train_vis=True)


def _shape(*dims):
    """A stand-in with only a shape: both knees read nothing else."""
    return types.SimpleNamespace(shape=dims)


@pytest.mark.parametrize("mode,rows,height,width,shards,expected", [
    ("auto", 3, 192, 640, 1, "float32"),     # 368,640 px: below
    ("auto", 7, 192, 640, 1, "float32"),     # 860,160 px: still below
    ("auto", 8, 192, 640, 1, "bfloat16"),    # 983,040 px: above
    ("auto", 1, 917504, 1, 1, "bfloat16"),   # exactly 7 * 2**17
    ("auto", 1, 917503, 1, 1, "float32"),
    ("auto", 4, 192, 640, 2, "bfloat16"),    # validation on 2 ranks: JAX sees the global 8 rows
    ("float32", 8, 192, 640, 1, "float32"),  # the explicit modes ignore the shape
    ("bfloat16", 3, 192, 640, 1, "bfloat16"),
    ("bfloat16", 1, 2, 2, 1, "bfloat16"),
])
def test_the_knee_agrees_with_jax(mode, rows, height, width, shards, expected):
    # NHWC in JAX, NCHW in the port: counting the port's shape[1] would count
    # channels. JAX's function sees rows * shards rows at once.
    jax_dtype = _image_dtype(_jcfg(mode), _shape(rows * shards, height, width, 3))
    port_dtype = warp_image_dtype(_tcfg(mode), _shape(rows, 3, height, width), shards)
    assert np.dtype(jax_dtype).name == str(port_dtype).removeprefix("torch.") == expected


@pytest.mark.parametrize("mode", ["auto", "float32", "bfloat16"])
def test_the_knee_without_an_image(mode):
    expected = "bfloat16" if mode == "bfloat16" else "float32"
    assert np.dtype(_image_dtype(_jcfg(mode))).name == str(warp_image_dtype(_tcfg(mode))).removeprefix("torch.") == expected


def _inputs(kind):
    rng = np.random.RandomState(0)
    img = rng.rand(B, H, W, C).astype(np.float32)
    grid = rng.uniform(-1.1, 1.1, (B, HO, WO, 2)).astype(np.float32)
    if kind == "on_border":  # coordinates at exactly 0 and size - 1
        grid = np.clip(grid, -1.0, 1.0)
        assert (np.abs(grid) == 1.0).sum() > 20
    cot = rng.randn(B, HO, WO, C).astype(np.float32)
    return img, grid, cot


def _jax_warp(img, grid, cot, excess_precision=True, fn=None):
    """JAX's ``image_dtype="bfloat16"`` warp (``fn`` of the bfloat16 image
    instead, where given) and its d_grid, compiled with or without excess
    precision."""
    def value(g):
        if fn is None:
            return _grid_sample(_jcfg("bfloat16"), jnp.asarray(img), g)
        return fn(jnp.asarray(img).astype(jnp.bfloat16), g)

    def loss(g):
        return jnp.sum(value(g) * cot)

    g = jnp.asarray(grid)
    opts = {"xla_allow_excess_precision": excess_precision}
    out = jax.jit(value).lower(g).compile(compiler_options=opts)(g)
    d_grid = jax.jit(jax.grad(loss)).lower(g).compile(compiler_options=opts)(g)
    return np.asarray(out), np.asarray(d_grid)


def _port_warp(img, grid, cot, dtype):
    """The port's warp of ``img`` cast to ``dtype`` (the plain version on the
    CPU): (output NHWC, d_grid, d_image NHWC in ``dtype``)."""
    im = torch.tensor(nhwc_to_nchw(img)).to(dtype).requires_grad_()
    gr = torch.tensor(grid, requires_grad=True)
    out = t_warp.grid_sample(im, gr)
    (out * torch.tensor(nhwc_to_nchw(cot))).sum().backward()
    assert out.dtype == torch.float32 and gr.grad.dtype == torch.float32 and im.grad.dtype == dtype
    return nchw_to_nhwc(out.detach().numpy()), gr.grad.numpy(), im.grad


@pytest.mark.parametrize("kind", ["random", "on_border"])
def test_bf16_warp_matches_jax(kind):
    img, grid, cot = _inputs(kind)
    ref, ref_dg = _jax_warp(img, grid, cot)
    out, d_grid, _ = _port_warp(img, grid, cot, torch.bfloat16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=VAL_ATOL)
    np.testing.assert_allclose(d_grid, ref_dg, rtol=0, atol=GRAD_RTOL * np.abs(ref_dg).max())


@pytest.mark.parametrize("kind", ["random", "on_border"])
def test_bf16_warp_matches_the_pallas_taps(kind):
    # The Pallas kernel (interpret mode on the CPU) gathers taps of the
    # image's dtype (warp_kernel.py:83) and lerps them as ops/warp.py does.
    img, grid, cot = _inputs(kind)
    ref, ref_dg = _jax_warp(img, grid, cot, fn=grid_sample_pallas)
    out, d_grid, _ = _port_warp(img, grid, cot, torch.bfloat16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=VAL_ATOL)
    np.testing.assert_allclose(d_grid, ref_dg, rtol=0, atol=GRAD_RTOL * np.abs(ref_dg).max())


@pytest.mark.parametrize("kind", ["random", "on_border"])
def test_the_float32_path_misses_jax_bf16(kind):
    # The port before --image_dtype took effect warped the float32 image
    # whatever the flag said: the same comparison fails, values and d_grid.
    img, grid, cot = _inputs(kind)
    ref, ref_dg = _jax_warp(img, grid, cot)
    out, d_grid, _ = _port_warp(img, grid, cot, torch.float32)
    assert np.abs(out - ref).max() > 100 * VAL_ATOL
    assert np.abs(d_grid - ref_dg).max() > 100 * GRAD_RTOL * np.abs(ref_dg).max()


def test_jax_without_excess_precision_rounds_the_tap_differences():
    img, grid, cot = _inputs("random")
    ref, ref_dg = _jax_warp(img, grid, cot, excess_precision=False)
    out, d_grid, _ = _port_warp(img, grid, cot, torch.bfloat16)
    gap, grad_gap = np.abs(out - ref).max(), np.abs(d_grid - ref_dg).max() / np.abs(ref_dg).max()
    assert VAL_ATOL < gap <= ROUNDED_ATOL and GRAD_RTOL < grad_gap <= ROUNDED_GRAD_RTOL, (gap, grad_gap)


def test_bf16_plain_warp_is_the_float32_warp_of_the_rounded_image():
    img, grid, cot = _inputs("random")
    rounded = torch.tensor(img).bfloat16().float().numpy()
    out, d_grid, d_img = _port_warp(img, grid, cot, torch.bfloat16)
    out32, d_grid32, d_img32 = _port_warp(rounded, grid, cot, torch.float32)
    np.testing.assert_array_equal(out, out32)
    np.testing.assert_array_equal(d_grid, d_grid32)
    # d_image: the float32 sums, rounded once to bfloat16.
    torch.testing.assert_close(d_img, d_img32.bfloat16(), rtol=0, atol=0)


def _recording_grid_sample(seen):
    def wrapped(image, grid):
        seen.append(image.dtype)
        return t_warp.grid_sample(image, grid)
    return wrapped


def _port_init_as_jax(cfg):
    """The port's random init from ``cfg.seed``, as the JAX package's
    variable trees (its ``convert_module``): the JAX ``init`` is not run,
    which saves its compile here; ``run_step`` carries the trees back into
    the port with ``load_jax_variables``."""
    model = Trainer(cfg, device="cpu", phase="fine_tune").model
    params, batch_stats = {}, {}
    for name in MODULE_NAMES:
        sd = {k: v.detach().numpy().copy() for k, v in getattr(model, name).state_dict().items()}
        params[name], stats = convert_module(name, sd, cfg)
        if stats:
            batch_stats[name] = stats
    return {"params": params, "batch_stats": batch_stats}


@pytest.fixture(scope="module")
def bf16_step():
    seen = []
    variables = _port_init_as_jax(TConfig(**KW, image_dtype="bfloat16"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_losses, "grid_sample", _recording_grid_sample(seen))
        mp.setattr(train_step_tests, "init_variables", lambda cfg: variables)
        r = train_step_tests.run_step("fine_tune", image_dtype="bfloat16")
    return r, seen


def test_fine_tune_step_under_bf16_images_matches_jax(bf16_step):
    r, seen = bf16_step
    # One warp per scale and source frame, each of a bfloat16 image.
    assert seen == [torch.bfloat16] * 6
    ref = r.jax[0]
    got = {k: v.item() for k, v in r.losses.items()}
    assert set(got) == set(ref)
    for k in ref:
        # As test_torch_train_step.test_losses_match: float32 maps through ~60
        # layers on each side, ~1e-5 relative; the RANSAC draws are shared,
        # so d_ground is held alike.
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    assert all(v == 0 for v in r.counts.values())


def test_view_synthesis_warps_the_image_the_knee_picks():
    # The same inputs under each mode: bfloat16 images change the warped
    # colours by the image's rounding (within test_image_dtype.py's 4e-3),
    # and the output stays float32; auto at this size warps float32.
    cfg = TConfig(**{**KW, "batch_size": 2})
    batch = synthetic_batch(cfg, 2, cfg.height, cfg.width)
    rng = np.random.RandomState(1)
    warped = {}
    for mode in ("float32", "bfloat16", "auto"):
        trainer = Trainer(dataclasses.replace(cfg, image_dtype=mode), device="cpu", phase="fine_tune")
        inputs = trainer.process_inputs_device(trainer.to_device(batch))
        outputs = {}
        for s in cfg.scales:
            h, w = cfg.height // 2 ** s, cfg.width // 2 ** s
            outputs[("disp", 0, s)] = torch.tensor(rng.rand(2, 1, h, w).astype(np.float32) * 0.3 + 0.02)
            rng = np.random.RandomState(1)
        for f in cfg.frame_ids[1:]:
            outputs[("cam_T_cam", 0, f)] = torch.eye(4).expand(2, 4, 4).clone()
            outputs[("cam_T_cam", 0, f)][:, 0, 3] = 0.05 * f
        seen = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(t_losses, "grid_sample", _recording_grid_sample(seen))
            t_losses.view_synthesis(trainer.cfg, inputs, outputs, bool_CmpFlow=False, bool_MotMask=False,
                                    automask=False)
        assert seen == [torch.bfloat16 if mode == "bfloat16" else torch.float32] * 6, mode
        warped[mode] = [outputs[("color", f, s)] for s in cfg.scales for f in cfg.frame_ids[1:]]
        assert all(w.dtype == torch.float32 for w in warped[mode])
    for a, b, c in zip(warped["float32"], warped["bfloat16"], warped["auto"]):
        assert torch.equal(a, c)
        gap = float((a - b).abs().max())
        assert 0 < gap < 4e-3


class _FakeCuda:
    """A tensor stand-in that says it lies on the card: enough for the
    wrappers' checks, which run before anything is built or launched."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.is_cuda, self.device = True, torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True


@pytest.mark.parametrize("image_dtype,grid_dtype,match", [
    (torch.float16, torch.float32, "float16"),
    (torch.float64, torch.float32, "float64"),
    (torch.bfloat16, torch.bfloat16, "the grid as torch.bfloat16"),
])
def test_the_cuda_wrappers_refuse_other_dtypes(image_dtype, grid_dtype, match):
    image = _FakeCuda((1, 3, 6, 8), image_dtype)
    grid = _FakeCuda((1, 5, 7, 2), grid_dtype)
    with pytest.raises(ValueError, match=match):
        t_warp.warp_fwd(image, grid)
    with pytest.raises(ValueError, match=match):
        t_warp.warp_bwd(image, grid, _FakeCuda((1, 3, 5, 7), torch.float32), True)
    assert all(v == 0 for v in t_warp.LAUNCHES.values())


def measured_gaps():
    """The gaps the tolerances above come from, on the random grid: the
    port's bfloat16 and float32 warps against JAX's bfloat16 warp, with
    excess precision on and off. -> {label: (max |values gap|, max |d_grid
    gap|, max |d_grid|)}."""
    img, grid, cot = _inputs("random")
    gaps = {}
    for excess in (True, False):
        ref, ref_dg = _jax_warp(img, grid, cot, excess_precision=excess)
        for dtype in (torch.bfloat16, torch.float32):
            out, d_grid, _ = _port_warp(img, grid, cot, dtype)
            label = f"port {str(dtype).removeprefix('torch.')} vs JAX bfloat16, excess precision {'on' if excess else 'off'}"
            gaps[label] = (float(np.abs(out - ref).max()), float(np.abs(d_grid - ref_dg).max()),
                           float(np.abs(ref_dg).max()))
    return gaps


if __name__ == "__main__":
    # python tests/test_torch_image_dtype.py (from the repository's root)
    for label, (values, grads, scale) in measured_gaps().items():
        print(f"{label}: values {values:.2e}, d_grid {grads:.2e} (|d_grid| up to {scale:.1f})")
