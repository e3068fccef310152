"""One ``fine_tune`` step of the port against the JAX package, on the CPU.

LiteMono at 32x64, batch 2, from the same weights (JAX init, carried across
by ``load_jax_variables``) and the same synthetic batch. Drop-path is off on
both sides (JAX: ``DropPath.__call__`` patched to the identity; port:
``drop_path_rate=0``). The RANSAC hypotheses are drawn on the JAX side
exactly as ``compute_losses`` draws them and handed to the port's draw
function. The JAX reference is built without ``Trainer``: one jitted
``value_and_grad`` over model apply, ``view_synthesis`` and
``compute_losses``, then ``optax.adam``, run once for the whole module.
"""

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
from dynamo_depth_torch.training.synthetic import synthetic_batch
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_torch.utils.layout import dict_to_nhwc
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.models import layers as j_layers
from dynamo_depth_tpu.models.convert import convert_module
from dynamo_depth_tpu.models.model import DynamoModel
from dynamo_depth_tpu.ops.warp import resize_bicubic_aa
from dynamo_depth_tpu.training.losses import compute_losses, view_synthesis
from dynamo_depth_tpu.training.trainer import PHASE_SPEC

B, H, W = 2, 32, 64
STEP, STEPS_PER_EPOCH = 5, 100  # ramp = 3 * 5 / 100: the ramped terms count
KW = dict(dataset="kitti", height=H, width=W, batch_size=B, weights_init="scratch")


def _jax_step(cfg, variables, batch, rng):
    bool_cmp, bool_mask, networks, lr_factor = PHASE_SPEC["fine_tune"]
    model = DynamoModel(depth_model="litemono", scales=tuple(cfg.scales), frame_ids=tuple(cfg.frame_ids))

    def pyramid(inputs):  # Trainer.process_inputs_device
        out = dict(inputs)
        for s in cfg.scales[1:]:
            out[("color", 0, s)] = resize_bicubic_aa(out[("color", 0, s - 1)], (H // 2 ** s, W // 2 ** s))
        return out

    def loss_fn(params, batch_stats, batch, rng):
        inputs = pyramid(batch)
        rng_drop, rng_loss = jax.random.split(rng)
        outputs, mut = model.apply(
            {"params": params, "batch_stats": batch_stats}, inputs, train=True,
            bool_CmpFlow=bool_cmp, bool_MotMask=bool_mask, mutable=["batch_stats"], rngs={"droppath": rng_drop},
        )
        view_synthesis(cfg, inputs, outputs, bool_CmpFlow=bool_cmp, bool_MotMask=bool_mask, automask=False)
        losses = compute_losses(
            cfg, inputs, outputs, rng_loss, bool_CmpFlow=bool_cmp, bool_MotMask=bool_mask, automask=False,
            trainable_networks=networks, step_in_phase=STEP, steps_per_epoch=STEPS_PER_EPOCH,
        )
        return losses["loss"], (losses, mut["batch_stats"])

    (_, (losses, new_bs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], batch, rng
    )
    tx = optax.adam(cfg.learning_rate * lr_factor)
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    new_params = optax.apply_updates(variables["params"], updates)
    return jax.tree.map(np.asarray, (losses, grads, new_params, new_bs))


def _ransac_indices(cfg, rng):
    """The indices compute_losses draws: split(rng_loss)[1] folded with the
    scale, uniform over the candidate rows of that scale's disparity."""
    _, rng_loss = jax.random.split(rng)
    _, rng_ground = jax.random.split(rng_loss)
    out = []
    for s in cfg.scales:
        h, w = H // 2 ** s, W // 2 ** s
        n = int(cfg.gp_prior * h) * w
        key = jax.random.fold_in(rng_ground, s)
        out.append(np.asarray(jax.random.randint(key, (B, cfg.gp_np_per_it * cfg.gp_max_it), 0, n)))
    return out


@pytest.fixture(scope="module")
def step_results():
    jcfg, tcfg = JConfig(**KW), TConfig(**KW)
    batch = synthetic_batch(tcfg, B, H, W)
    batch_nhwc = dict_to_nhwc(batch)
    rng = jax.random.PRNGKey(7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_layers.DropPath, "__call__", lambda self, x, train=False: x)
        model = DynamoModel(depth_model="litemono", scales=tuple(jcfg.scales), frame_ids=tuple(jcfg.frame_ids))
        dummy = {("color_aug", f, 0): jnp.zeros((1, H, W, 3)) for f in jcfg.frame_ids}
        variables = jax.jit(lambda k: model.init({"params": k, "droppath": k}, dummy, train=False))(
            jax.random.PRNGKey(0)
        )
        variables = jax.tree.map(np.asarray, dict(variables))
        jax_out = _jax_step(jcfg, variables, jax.tree.map(jnp.asarray, batch_nhwc), rng)

    trainer = Trainer(tcfg, device="cpu", steps_per_epoch=STEPS_PER_EPOCH, drop_path_rate=0.0)
    load_jax_variables(trainer.model, variables["params"], variables["batch_stats"], tcfg)
    indices = _ransac_indices(jcfg, rng)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_ground_plane, "draw_sample_idx", lambda *a, **k: torch.tensor(indices.pop(0)))
        reset_launch_counts()
        losses = trainer.train_step(trainer.to_device(batch), torch.Generator().manual_seed(0), STEP)
        counts = launch_counts()
    assert not indices, "every scale drew its RANSAC hypotheses once"
    return types.SimpleNamespace(
        cfg=tcfg, jax=jax_out, losses=losses, trainer=trainer, variables=variables, counts=counts
    )


def _port_tree(trainer, module_name, cfg, grads=False):
    """The port module's weights (or gradients) as the flax (params,
    batch_stats) trees, through the JAX package's torch -> flax converter."""
    mod = getattr(trainer.model, module_name)
    sd = {k: v.detach().numpy().copy() for k, v in mod.state_dict().items()}
    if grads:
        for k, p in mod.named_parameters():
            sd[k] = np.zeros_like(sd[k]) if p.grad is None else p.grad.numpy().copy()
    return convert_module(module_name, sd, types.SimpleNamespace(depth_model="litemono", scales=cfg.scales))


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def test_synthetic_batch_matches_graft_entry():
    cfg = TConfig(**KW)
    ref = __graft_entry__._synthetic_batch(cfg, B, H, W)
    ours = dict_to_nhwc(synthetic_batch(cfg, B, H, W))
    assert ref.keys() == ours.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=str(k))


def test_losses_match(step_results):
    ref = step_results.jax[0]
    got = {k: v.item() for k, v in step_results.losses.items()}
    assert set(got) == set(ref)
    for k in ref:
        # Every term is a mean over the batch of float32 maps that went
        # through ~60 layers of convolutions on each side: ~1e-5 relative.
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    assert got["loss_term/d_ground"] > 0 and got["loss_term/m_sparsity"] > 0


@pytest.mark.parametrize("module_name", MODULE_NAMES)
def test_gradients_match(step_results, module_name):
    r = step_results
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


@pytest.mark.parametrize("module_name", MODULE_NAMES)
def test_params_after_adam_match(step_results, module_name):
    r = step_results
    port, _ = _port_tree(r.trainer, module_name, r.cfg)
    port_grad, _ = _port_tree(r.trainer, module_name, r.cfg, grads=True)
    ref_new = _leaves(r.jax[2][module_name])
    ref_grad = _leaves(r.jax[1][module_name])
    old = _leaves(r.variables["params"][module_name])
    got, got_grad = _leaves(port), _leaves(port_grad)
    lr = r.cfg.learning_rate * 0.5
    assert ref_new.keys() == got.keys()
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
        assert agree.mean() > 0.5, (k, agree.mean())
        assert np.all(np.abs(d_got - d_ref)[agree] <= tol[agree]), k


def test_batch_stats_match(step_results):
    r = step_results
    for module_name in ("depth_enc", "pose_enc", "motion_enc"):
        _, stats = _port_tree(r.trainer, module_name, r.cfg)
        ref = _leaves(r.jax[3][module_name])
        got = _leaves(stats)
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5 * np.max(np.abs(ref[k])), err_msg=str(k))


def test_cpu_step_launches_no_kernel(step_results):
    assert all(v == 0 for v in step_results.counts.values())
