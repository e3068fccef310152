"""The port's bfloat16 compute path against the JAX package's, on the CPU.

LiteMono at 32x64, batch 2, one ``fine_tune`` step from the same weights
(``test_torch_train_step.run_step``) on each of ``BATCHES`` synthetic batches:
the JAX step in float32 and in bfloat16 (flax ``dtype=``), and the port's step
with ``compute_dtype="bfloat16"`` (``torch.autocast`` around the networks,
outputs cast to float32). The two bfloat16 steps round differently (autocast
keeps LayerNorm and some reductions in float32), so the port is held by its
accuracy against the JAX float32 step, not by agreement with JAX's bfloat16
step. For every loss term and every module's gradient (the relative L2 error
of the whole gradient, which bounds the error of its norm):

    median |port_bf16 - jax_f32| <= max(K * median |jax_bf16 - jax_f32|, tol * |jax_f32|)

over the batches, with K = 2 and tol = 1e-3 (5e-2 for ``d_ground``, whose
RANSAC inlier count is discrete).

Why medians over batches: at random init one step is chaotic in its discrete
choices (the minimum over source frames, RANSAC's inliers, the static mask).
A 1e-6 relative change of the networks' outputs moved the port's float32
gradient with respect to the disparity by 1e-2 of its norm, so a bfloat16
step (1e-2 relative change) moves them by tens of percent in both packages:
per batch, the port's error over JAX's ranged from 0.02 to 86 across loss
terms. Why ``xla_allow_excess_precision`` is off in the JAX bfloat16 step:
by default XLA's CPU compiler keeps float32 between the operations it fuses,
which flax's ``dtype=`` does not ask for; against that step the port's pose
and flow outputs were 1.5-3.1x its error (disparity and mask 0.55-0.85x),
against the true bfloat16 step 0.55-1.15x.

Found on this CPU over 4 batches (port median / JAX median): loss terms
0.08-1.32, except ``c_consistency`` at 2.25, which gets K = 4 (its
|complete flow - ego flow| is a difference of two bfloat16-rounded flows);
gradients 0.90-1.18; gradient norms alone 0.50-1.84. Besides: view synthesis,
``backproject`` and the ground-plane solve see float32 tensors outside any
autocast region, the kernels' wrappers refuse bfloat16, parameters, BatchNorm
statistics and Adam's state stay float32, TF32 stays off,
``Trainer.predict`` returns float32, and the convergence script writes both
dtypes' metrics.
"""

import json

import numpy as np
import pytest
import torch

from dynamo_depth_torch.bench import bf16_convergence
from dynamo_depth_torch.models.model import MODULE_NAMES
from dynamo_depth_torch.ops.kernels import photometric, warp
from dynamo_depth_torch.training import losses as t_losses
from dynamo_depth_torch.training import trainer as trainer_mod
from dynamo_depth_torch.training.synthetic import synthetic_batch
from test_torch_train_step import _leaves, _port_tree, run_step
from torch_test_threads import two_torch_threads  # noqa: F401

BATCHES = 4
K = {"loss_term/c_consistency": 4.0}  # else 2
TOL = {"loss_term/d_ground": 5e-2}  # else 1e-3
SEEN = {"view_synthesis": [], "backproject": [], "ground_plane_fit": []}


def _float_dtypes(*dicts):
    return {v.dtype for d in dicts for v in d.values() if torch.is_tensor(v) and v.is_floating_point()}


def _recording(name, fn, dtypes_of):
    def wrapped(*args, **kwargs):
        SEEN[name].append((torch.is_autocast_enabled("cpu"), dtypes_of(*args)))
        return fn(*args, **kwargs)
    return wrapped


@pytest.fixture(scope="module")
def steps():
    for v in SEEN.values():
        v.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "view_synthesis", _recording(
            "view_synthesis", trainer_mod.view_synthesis, lambda cfg, inputs, outputs: _float_dtypes(inputs, outputs)))
        mp.setattr(t_losses, "backproject", _recording(
            "backproject", t_losses.backproject, lambda depth, inv_K: {depth.dtype, inv_K.dtype}))
        mp.setattr(t_losses, "ground_plane_fit", _recording(
            "ground_plane_fit", t_losses.ground_plane_fit, lambda pts, generator: {pts.dtype}))
        return [run_step("fine_tune", jax_dtypes=("float32", "bfloat16"), batch_seed=i, compute_dtype="bfloat16")
                for i in range(BATCHES)]


def _within_rule(name, port_err, jax_err, ref):
    port_err, jax_err, ref = np.median(port_err), np.median(jax_err), np.median(np.abs(ref))
    bound = max(K.get(name, 2.0) * jax_err, TOL.get(name, 1e-3) * ref)
    assert port_err <= bound, (name, port_err, jax_err, port_err / jax_err)


def test_the_jax_steps_differ(steps):
    # The JAX bfloat16 step is a bfloat16 step: its losses moved.
    for r in steps:
        assert float(r.jax_by_dtype["bfloat16"][0]["loss"]) != float(r.jax[0]["loss"])


def test_loss_terms_no_less_accurate_than_jax(steps):
    names = [k for k in steps[0].jax[0] if not k.startswith("loss_coef/")]
    assert set(steps[0].jax[0]) == set(steps[0].losses) and len(names) == 11
    for k in names:
        ref = np.array([float(r.jax[0][k]) for r in steps])
        port = np.array([r.losses[k].item() for r in steps])
        assert np.isfinite(port).all(), k
        jax_bf16 = np.array([float(r.jax_by_dtype["bfloat16"][0][k]) for r in steps])
        _within_rule(k, np.abs(port - ref), np.abs(jax_bf16 - ref), ref)


def _vector(tree):
    leaves = sorted(_leaves(tree).items(), key=lambda kv: str(kv[0]))
    return np.concatenate([np.asarray(v, np.float64).ravel() for _, v in leaves])


@pytest.mark.parametrize("module_name", MODULE_NAMES)
def test_gradients_no_less_accurate_than_jax(steps, module_name):
    errs = []
    for r in steps:
        ref = _vector(r.jax[1][module_name])
        port = _vector(_port_tree(r.trainer, module_name, r.cfg, grads=True)[0])
        jax_bf16 = _vector(r.jax_by_dtype["bfloat16"][1][module_name])
        errs.append((np.linalg.norm(port - ref), np.linalg.norm(jax_bf16 - ref), np.linalg.norm(ref)))
    port_err, jax_err, norm = np.array(errs).T
    _within_rule(f"grad/{module_name}", port_err / norm, jax_err / norm, np.ones_like(norm))


def test_view_synthesis_sees_float32_only(steps):
    assert len(SEEN["view_synthesis"]) == BATCHES
    for autocast, dtypes in SEEN["view_synthesis"]:
        assert not autocast and dtypes == {torch.float32}, dtypes


def test_backproject_and_the_ground_plane_solve_run_in_float32(steps):
    # Per step: backproject once per scale in view synthesis and once per
    # scale for the ground term; the ground-plane fit once per scale.
    assert len(SEEN["backproject"]) == 6 * BATCHES and len(SEEN["ground_plane_fit"]) == 3 * BATCHES
    for name in ("backproject", "ground_plane_fit"):
        for autocast, dtypes in SEEN[name]:
            assert not autocast and dtypes == {torch.float32}, (name, dtypes)


def test_parameters_and_batch_stats_stay_float32(steps):
    trainer = steps[0].trainer
    floats = {v.dtype for v in trainer.model.state_dict().values() if v.is_floating_point()}
    assert floats == {torch.float32}
    state = [t for s in trainer.optimizer.state.values() for t in s.values() if t.is_floating_point()]
    assert state and {t.dtype for t in state} == {torch.float32}


def test_tf32_stays_off(steps):
    assert steps[0].trainer.compute_dtype == torch.bfloat16
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_predict_returns_float32(steps):
    trainer, cfg = steps[0].trainer, steps[0].cfg
    out = trainer.predict(synthetic_batch(cfg, cfg.batch_size, cfg.height, cfg.width), True, True)
    assert {v.dtype for v in out.values()} == {torch.float32}
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


def test_kernel_wrappers_refuse_bfloat16():
    img = torch.rand(1, 3, 6, 8, dtype=torch.bfloat16)
    grid = torch.rand(1, 5, 7, 2, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        warp.warp_fwd(img, grid)
    with pytest.raises(ValueError, match="float32"):
        warp.warp_bwd(img, grid, torch.rand(1, 3, 5, 7, dtype=torch.bfloat16), True)
    with pytest.raises(ValueError, match="float32"):
        photometric.photometric_fwd(img, img, 0.85)
    with pytest.raises(ValueError, match="float32"):
        photometric.photometric_bwd(img, img, torch.rand(1, 1, 6, 8, dtype=torch.bfloat16), 0.85, True)


def test_the_convergence_script_writes_both_dtypes(tmp_path):
    argv = ["--out", str(tmp_path), "--height", "32", "--width", "64", "--batch_size", "2", "--steps-per-epoch", "2",
            "--epochs", "1", "1", "1", "1", "--val_every", "1", "--n_frames", "12"]
    bf16_convergence.main(argv, device="cpu")
    summary = json.loads((tmp_path / "bf16_convergence.json").read_text())
    assert set(summary["results"]) == {"float32", "bfloat16"}
    for dt, r in summary["results"].items():
        assert r["steps"] == 8 and len(r["history"]) == 8, dt
        assert all(np.isfinite(r["final"][k]) for k in bf16_convergence.DEPTH_KEYS), dt
        assert 0 < r["final"]["de:abs_rel"] < 10 and 0 <= r["final"]["da:a1"] <= 1, dt
