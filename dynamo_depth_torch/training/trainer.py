"""The ``fine_tune`` training step (port of
``dynamo_depth_tpu.training.trainer``, reference ``Trainer.py:466-497``).

One :class:`Trainer` holds the model, the optimizer of one curriculum phase
and the step. Per phase: the trainable networks (``PHASE_SPEC``), untrained
modules frozen, a fresh Adam (eps 1e-8, the update optax.adam makes) with the
step-halving learning-rate schedule, and the colour pyramid built on the
device. Only ``fine_tune`` is ported; the other phases, checkpoints, data
loading and evaluation come in later slices.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dynamo_depth_torch.config import DynamoConfig
from dynamo_depth_torch.models.model import MODULE_NAMES, DynamoModel, modules_for_networks
from dynamo_depth_torch.ops.warp import resize_bicubic_aa
from dynamo_depth_torch.training.losses import compute_losses, view_synthesis

# Phase -> (bool_CmpFlow, bool_MotMask, trainable networks, lr factor)
# (Trainer.py:466-490).
PHASE_SPEC = {
    "disp_init": (False, False, ("Depth", "Pose"), 1.0),
    "motion_init": (True, False, ("CmpFlow",), 1.0),
    "mask_init": (True, True, ("Pose", "CmpFlow", "MotMask"), 1.0),
    "fine_tune": (True, True, ("Depth", "Pose", "CmpFlow", "MotMask"), 0.5),
}


def resolve_device(device: Optional[str]) -> torch.device:
    """The card unless the caller asks for the CPU; raises without a card."""
    if device is None or str(device).startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device(device or "cuda")
    return torch.device(device)


class Trainer:
    """Model + optimizer + the ``fine_tune`` train step.

    :param cfg: the run's config (``weights_init`` must be ``"scratch"``: the
        imagenet backbones are not in the repository)
    :param device: ``"cuda"`` (default) or ``"cpu"``
    :param steps_per_epoch: steps of one epoch, for the loss-weight ramp and
        the learning-rate schedule (defaults to ``cfg.epoch_size``, the
        length of the JAX package's epoch loader)
    :param drop_path_rate: LiteMono stochastic depth (0.4 in the reference)
    """

    phase = "fine_tune"  # the one phase ported so far

    def __init__(self, cfg: DynamoConfig, device: Optional[str] = None, steps_per_epoch: Optional[int] = None,
                 drop_path_rate: float = 0.4):
        cfg.validate()
        if cfg.weights_init != "scratch":
            raise NotImplementedError("only weights_init='scratch' is ported: the pretrained backbones are not in the repository")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError("only compute_dtype='float32' is ported")
        self.cfg = cfg
        self.device = resolve_device(device)
        # The JAX package runs float32 models at Precision.HIGHEST; on the
        # card that means no TF32 in cuDNN convolutions or cuBLAS matmuls.
        # These are process-wide switches.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

        self.bool_cmp, self.bool_mask, self.networks, lr_factor = PHASE_SPEC[self.phase]
        self.automask = self.phase == "disp_init"
        self.steps_per_epoch = steps_per_epoch or max(cfg.epoch_size, 1)
        self.base_lr = cfg.learning_rate * lr_factor

        torch.manual_seed(cfg.seed)
        self.model = DynamoModel(
            depth_model=cfg.depth_model, encoder_num_layers=cfg.encoder_num_layers,
            scales=tuple(cfg.scales), frame_ids=tuple(cfg.frame_ids), drop_path_rate=drop_path_rate,
        ).to(self.device)
        self.trainable_modules = modules_for_networks(self.networks)
        for name in MODULE_NAMES:
            getattr(self.model, name).requires_grad_(name in self.trainable_modules)
        params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.Adam(params, lr=self.lr_at(0), betas=(0.9, 0.999), eps=1e-8)
        self.opt_steps = 0

    def lr_at(self, count: int) -> float:
        """Step-halving schedule: base * 0.5 ** (epoch // scheduler_step_size)."""
        epoch = count // max(self.steps_per_epoch, 1)
        return self.base_lr * (0.5 ** (epoch // self.cfg.scheduler_step_size))

    def process_inputs_device(self, inputs: Dict) -> Dict:
        """Colour pyramid ('color', 0, s) by recursive antialiased bicubic
        halving with clamping (Trainer.py:729-734), on the device."""
        out = dict(inputs)
        for scale in self.cfg.scales:
            if scale == 0:
                continue
            h, w = self.cfg.height // (2 ** scale), self.cfg.width // (2 ** scale)
            out[("color", 0, scale)] = resize_bicubic_aa(out[("color", 0, scale - 1)], (h, w))
        return out

    def to_device(self, batch: Dict) -> Dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def train_step(self, batch: Dict, generator: torch.Generator, step: int) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (NCHW tensors on the device).
        ``generator`` (on the device) draws drop-path masks and RANSAC
        hypotheses; ``step`` is the step within the phase (loss-weight ramp).
        Returns the detached losses dict of ``compute_losses``."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_at(self.opt_steps)
        self.optimizer.zero_grad(set_to_none=True)
        inputs = self.process_inputs_device(batch)
        self.model.train()
        outputs = self.model(inputs, bool_CmpFlow=self.bool_cmp, bool_MotMask=self.bool_mask, generator=generator)
        view_synthesis(self.cfg, inputs, outputs, bool_CmpFlow=self.bool_cmp, bool_MotMask=self.bool_mask,
                       automask=self.automask)
        losses = compute_losses(
            self.cfg, inputs, outputs, generator,
            bool_CmpFlow=self.bool_cmp, bool_MotMask=self.bool_mask, automask=self.automask,
            trainable_networks=self.networks, step_in_phase=step, steps_per_epoch=self.steps_per_epoch,
        )
        losses["loss"].backward()
        self.optimizer.step()
        self.opt_steps += 1
        return {k: v.detach() for k, v in losses.items()}
