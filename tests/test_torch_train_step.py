"""One step of each curriculum phase of the port against the JAX package,
on the CPU.

LiteMono at 32x64, batch 2, from the same weights (JAX init, carried across
by ``load_jax_variables``) and the same synthetic batch. Drop-path is off on
both sides (JAX: ``DropPath.__call__`` patched to the identity; port:
``drop_path_rate=0``). The RANSAC hypotheses and the automask noise are
drawn on the JAX side exactly as ``compute_losses`` draws them and handed to
the port's draw functions. The JAX reference is built without ``Trainer``:
one jitted ``value_and_grad`` over the trainable modules' parameters of
model apply, ``view_synthesis`` and ``compute_losses``, then ``optax.adam``,
run once per phase. This file runs ``fine_tune`` and ``disp_init``;
``test_torch_phase_steps.py`` runs the same tests on the other two phases.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.models.convert import load_jax_variables
from dynamo_depth_torch.models.model import MODULE_NAMES
from dynamo_depth_torch.ops import ground_plane as t_ground_plane
from dynamo_depth_torch.ops.kernels import launch_counts, reset_launch_counts
from dynamo_depth_torch.training import losses as t_losses
from dynamo_depth_torch.training.synthetic import synthetic_batch
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.models import layers as j_layers
from dynamo_depth_tpu.models.convert import convert_module
from dynamo_depth_tpu.models.model import DynamoModel, modules_for_networks
from dynamo_depth_tpu.ops.warp import resize_bicubic_aa
from dynamo_depth_tpu.training.losses import compute_losses, view_synthesis
from dynamo_depth_tpu.training.trainer import PHASE_SPEC, _outputs_to_f32
from torch_test_threads import two_torch_threads  # noqa: F401

B, H, W = 2, 32, 64
STEP, STEPS_PER_EPOCH = 5, 100  # ramp = 3 * 5 / 100: the ramped terms count
KW = dict(dataset="kitti", height=H, width=W, batch_size=B, weights_init="scratch")


def jax_model(cfg):
    return DynamoModel(depth_model=cfg.depth_model, encoder_num_layers=cfg.encoder_num_layers,
                       scales=tuple(cfg.scales), frame_ids=tuple(cfg.frame_ids),
                       dtype=jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32)


_STEP_FNS = {}


def _jax_step(cfg, phase, variables, batch, rng):
    """One JAX step of ``phase``; the compiled step is kept per config."""
    key = (phase, repr(cfg))
    if key not in _STEP_FNS:
        _STEP_FNS[key] = _jax_step_fn(cfg, phase)
    return _STEP_FNS[key](variables, batch, rng)


def _jax_step_fn(cfg, phase):
    bool_cmp, bool_mask, networks, lr_factor = PHASE_SPEC[phase]
    automask = phase == "disp_init"
    trainable = modules_for_networks(networks)
    model = jax_model(cfg)

    def pyramid(inputs):  # Trainer.process_inputs_device
        out = dict(inputs)
        for s in cfg.scales[1:]:
            out[("color", 0, s)] = resize_bicubic_aa(out[("color", 0, s - 1)],
                                                     (cfg.height // 2 ** s, cfg.width // 2 ** s))
        return out

    def loss_fn(t_params, f_params, batch_stats, batch, rng):
        inputs = pyramid(batch)
        rng_drop, rng_loss = jax.random.split(rng)
        outputs, mut = model.apply(
            {"params": {**f_params, **t_params}, "batch_stats": batch_stats}, inputs, train=True,
            bool_CmpFlow=bool_cmp, bool_MotMask=bool_mask, mutable=["batch_stats"], rngs={"droppath": rng_drop},
        )
        outputs = _outputs_to_f32(outputs)
        view_synthesis(cfg, inputs, outputs, bool_CmpFlow=bool_cmp, bool_MotMask=bool_mask, automask=automask)
        losses = compute_losses(
            cfg, inputs, outputs, rng_loss, bool_CmpFlow=bool_cmp, bool_MotMask=bool_mask, automask=automask,
            trainable_networks=networks, step_in_phase=STEP, steps_per_epoch=STEPS_PER_EPOCH,
        )
        return losses["loss"], (losses, mut["batch_stats"])

    jitted = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    compiled = []
    tx = optax.adam(cfg.learning_rate * lr_factor)

    def grad_fn(*args):
        # A bfloat16 step rounds every operation's result to bfloat16, as
        # flax's dtype= asks: XLA's CPU compiler would otherwise keep float32
        # between the operations it fuses (excess precision).
        if not compiled:
            bf16 = cfg.compute_dtype == "bfloat16"
            compiled.append(jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False}) if bf16 else jitted)
        return compiled[0](*args)

    def step(variables, batch, rng):
        # The trainer's partition: gradients of the trainable modules only.
        t_params = {k: v for k, v in variables["params"].items() if k in trainable}
        f_params = {k: v for k, v in variables["params"].items() if k not in trainable}
        (_, (losses, new_bs)), grads = grad_fn(t_params, f_params, variables["batch_stats"], batch, rng)
        updates, _ = tx.update(grads, tx.init(t_params), t_params)
        new_params = {**f_params, **optax.apply_updates(t_params, updates)}
        return jax.tree.map(np.asarray, (losses, grads, new_params, new_bs))

    return step


def _jax_draws(cfg, phase, rng):
    """What compute_losses draws from split(rng)[1] = rng_loss, split again
    into (rng_noise, rng_ground), each folded with the scale: the automask
    noise (disp_init; NHWC, handed to the port as (B, F, H, W)) and the
    RANSAC indices, uniform over the candidate rows of that scale's
    disparity (where the ground term runs)."""
    bool_cmp, bool_mask, networks, _ = PHASE_SPEC[phase]
    B, H, W = cfg.batch_size, cfg.height, cfg.width
    _, rng_loss = jax.random.split(rng)
    rng_noise, rng_ground = jax.random.split(rng_loss)
    noise, indices = [], []
    for s in cfg.scales:
        if phase == "disp_init":
            shape = (B, H, W, len(cfg.frame_ids) - 1)
            noise.append(np.asarray(jax.random.normal(jax.random.fold_in(rng_noise, s), shape)).transpose(0, 3, 1, 2))
        if "Depth" in networks and bool_mask:
            h, w = H // 2 ** s, W // 2 ** s
            n = int(cfg.gp_prior * h) * w
            key = jax.random.fold_in(rng_ground, s)
            indices.append(np.asarray(jax.random.randint(key, (B, cfg.gp_np_per_it * cfg.gp_max_it), 0, n)))
    return noise, indices


_VARIABLES = {}


def init_variables(cfg):
    """The JAX model's float32 weights from key 0, as numpy trees (made once
    per config; read only)."""
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    if repr(cfg) not in _VARIABLES:
        model = jax_model(cfg)
        dummy = {("color_aug", f, 0): jnp.zeros((1, cfg.height, cfg.width, 3)) for f in cfg.frame_ids}
        variables = jax.jit(lambda k: model.init({"params": k, "droppath": k}, dummy, train=False))(
            jax.random.PRNGKey(0))
        _VARIABLES[repr(cfg)] = jax.tree.map(np.asarray, dict(variables))
    return _VARIABLES[repr(cfg)]


def run_step(phase, jax_dtypes=("float32",), batch_seed=0, **overrides):
    """One step of ``phase`` in both packages from the same weights and batch.
    ``overrides`` set config fields of both (the port's ``compute_dtype``
    among them); the JAX step runs once for each of ``jax_dtypes``, and
    ``.jax`` holds the first run, ``.jax_by_dtype`` all of them.
    ``batch_seed`` draws another synthetic batch and RANSAC key."""
    kw = {**KW, **overrides}
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    batch = synthetic_batch(tcfg, tcfg.batch_size, tcfg.height, tcfg.width, seed=batch_seed)
    rng = jax.random.PRNGKey(7 + batch_seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_layers.DropPath, "__call__", lambda self, x, train=False: x)
        variables = init_variables(jcfg)
        jax_by_dtype = {
            dt: _jax_step(dataclasses.replace(jcfg, compute_dtype=dt), phase, variables,
                          jax.tree.map(jnp.asarray, batch), rng)
            for dt in jax_dtypes
        }

    trainer = Trainer(tcfg, device="cpu", phase=phase, steps_per_epoch=STEPS_PER_EPOCH, drop_path_rate=0.0)
    load_jax_variables(trainer.model, variables["params"], variables["batch_stats"], tcfg)
    noise, indices = _jax_draws(jcfg, phase, rng)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_ground_plane, "draw_sample_idx", lambda *a, **k: torch.tensor(indices.pop(0)))
        mp.setattr(t_losses, "draw_automask_noise", lambda *a, **k: torch.tensor(noise.pop(0)))
        reset_launch_counts()
        losses = trainer.train_step(trainer.to_device(batch), torch.Generator().manual_seed(0), STEP)
        counts = launch_counts()
    assert not indices and not noise, "every scale drew its RANSAC hypotheses and automask noise once"
    return types.SimpleNamespace(
        phase=phase, cfg=tcfg, jax=jax_by_dtype[jax_dtypes[0]], jax_by_dtype=jax_by_dtype, losses=losses,
        trainer=trainer, variables=variables, counts=counts,
    )


# The other two phases run in test_torch_phase_steps.py, so that two test
# workers compile the JAX steps at once.
@pytest.fixture(scope="module", params=["fine_tune", "disp_init"])
def step_results(request):
    return run_step(request.param)


def _port_tree(trainer, module_name, cfg, grads=False):
    """The port module's weights (or gradients) as the flax (params,
    batch_stats) trees, through the JAX package's torch -> flax converter."""
    mod = getattr(trainer.model, module_name)
    sd = {k: v.detach().numpy().copy() for k, v in mod.state_dict().items()}
    if grads:
        for k, p in mod.named_parameters():
            sd[k] = np.zeros_like(sd[k]) if p.grad is None else p.grad.numpy().copy()
    return convert_module(module_name, sd, cfg)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def test_synthetic_batch_matches_graft_entry():
    cfg = TConfig(**KW)
    ref = __graft_entry__._synthetic_batch(cfg, B, H, W)
    ours = synthetic_batch(cfg, B, H, W)
    assert ref.keys() == ours.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=str(k))


# The terms each phase computes (the others stay 0 in both packages).
ACTIVE = {
    "disp_init": ("p_photo", "d_smooth"),
    "motion_init": ("p_photo", "c_smooth"),
    "mask_init": ("p_photo", "c_smooth", "c_consistency", "m_sparsity", "m_smooth"),
    "fine_tune": ("p_photo", "d_smooth", "d_ground", "c_smooth", "c_consistency", "m_sparsity", "m_smooth"),
}


def test_losses_match(step_results):
    ref = step_results.jax[0]
    got = {k: v.item() for k, v in step_results.losses.items()}
    assert set(got) == set(ref)
    for k in ref:
        # Every term is a mean over the batch of float32 maps that went
        # through ~60 layers of convolutions on each side: ~1e-5 relative.
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    for term in ("p_photo", "d_smooth", "d_ground", "c_smooth", "c_consistency", "m_sparsity", "m_smooth"):
        assert (got[f"loss_term/{term}"] > 0) == (term in ACTIVE[step_results.phase]), term


@pytest.mark.parametrize("module_name", MODULE_NAMES)
def test_gradients_match(step_results, module_name):
    r = step_results
    if module_name not in r.jax[1]:  # frozen in this phase: no gradient
        assert all(p.grad is None for p in getattr(r.trainer.model, module_name).parameters()), module_name
        return
    port, _ = _port_tree(r.trainer, module_name, r.cfg, grads=True)
    ref = _leaves(r.jax[1][module_name])
    got = _leaves(port)
    assert ref.keys() == got.keys()
    diff = np.sqrt(sum(np.sum((got[k] - ref[k]) ** 2) for k in ref))
    norm = np.sqrt(sum(np.sum(ref[k] ** 2) for k in ref))
    # The whole gradient of a module, through the backward of BatchNorm in
    # train mode, the warp and the SSIM: float32 round-off of two different
    # summation orders, ~1e-5 of the gradient norm.
    assert norm > 0 and diff / norm < 1e-3, (module_name, diff / norm)
    for k in ref:
        scale = np.max(np.abs(ref[k]))
        assert np.max(np.abs(got[k] - ref[k])) <= 1e-2 * scale + 1e-12, (module_name, k)


# At random init motion_init's motion-encoder gradient is ill-conditioned:
# scaling the input images by 1 + 1e-7 moves it by 3.7e-4 of its norm (7.3e-5
# in fine_tune), so fewer of its entries agree to 1e-3 across two packages
# that round differently (0.44 of one bias vector at least).
MIN_AGREE = {("motion_init", "motion_enc"): 0.4}


@pytest.mark.parametrize("module_name", MODULE_NAMES)
def test_params_after_adam_match(step_results, module_name):
    r = step_results
    port, _ = _port_tree(r.trainer, module_name, r.cfg)
    ref_new = _leaves(r.jax[2][module_name])
    old = _leaves(r.variables["params"][module_name])
    got = _leaves(port)
    assert ref_new.keys() == got.keys()
    if module_name not in r.jax[1]:  # frozen in this phase: not updated, bit for bit
        for k in ref_new:
            np.testing.assert_array_equal(got[k], old[k], err_msg=str(k))
            np.testing.assert_array_equal(ref_new[k], old[k], err_msg=str(k))
        return
    port_grad, _ = _port_tree(r.trainer, module_name, r.cfg, grads=True)
    ref_grad = _leaves(r.jax[1][module_name])
    got_grad = _leaves(port_grad)
    lr = r.cfg.learning_rate * PHASE_SPEC[r.phase][3]
    for k in ref_new:
        d_ref = ref_new[k] - old[k]
        d_got = got[k] - old[k]
        # float32 spacing of the weights bounds how exactly a step of ~lr can
        # be read back from new - old.
        tol = 1e-2 * lr + 2 * np.spacing(np.maximum(np.abs(old[k]), np.abs(got[k])))
        # Adam's first step is -lr * g / (|g| + 1e-8) of the port's own gradient...
        g = got_grad[k]
        assert np.all(np.abs(d_got + lr * g / (np.abs(g) + 1e-8)) <= tol), k
        # ...and equals optax's step wherever the two gradients agree to 1e-3
        # (most weights; the others sit near a zero of the gradient, where
        # round-off decides its sign: the gradients themselves are held in
        # test_gradients_match).
        agree = np.abs(g - ref_grad[k]) <= 1e-3 * np.abs(ref_grad[k])
        assert agree.mean() > MIN_AGREE.get((r.phase, module_name), 0.5), (k, agree.mean())
        assert np.all(np.abs(d_got - d_ref)[agree] <= tol[agree]), k


def test_batch_stats_match(step_results):
    # Frozen modules' statistics follow the batch too, in both packages; a
    # module the phase does not run (the motion encoder in disp_init) keeps
    # its initial statistics.
    r = step_results
    for module_name in ("depth_enc", "pose_enc", "motion_enc"):
        _, stats = _port_tree(r.trainer, module_name, r.cfg)
        ref = _leaves(r.jax[3].get(module_name, r.variables["batch_stats"][module_name]))
        got = _leaves(stats)
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5 * np.max(np.abs(ref[k])), err_msg=str(k))


def test_cpu_step_launches_no_kernel(step_results):
    assert all(v == 0 for v in step_results.counts.values())
