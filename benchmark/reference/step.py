"""One optimizer step of a curriculum phase, in plain PyTorch: the colour
pyramid, the networks' forward, view synthesis, every loss term, the
backward and Adam (a frozen copy of the program's ``Trainer.train_step`` at
world size 1, float32). Parameters, Adam's state and the BatchNorm
statistics are this object's own.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict

import torch

from benchmark.reference.image import resize_bicubic_aa
from benchmark.reference.losses import compute_losses, view_synthesis
from benchmark.reference.model import MODULE_NAMES, DynamoModel, modules_for_networks

# Phase -> (bool_CmpFlow, bool_MotMask, trainable networks, lr factor)
# (Trainer.py:466-490).
PHASE_SPEC = {
    "disp_init": (False, False, ("Depth", "Pose"), 1.0),
    "motion_init": (True, False, ("CmpFlow",), 1.0),
    "mask_init": (True, True, ("Pose", "CmpFlow", "MotMask"), 1.0),
    "fine_tune": (True, True, ("Depth", "Pose", "CmpFlow", "MotMask"), 0.5),
}
BETAS = (0.9, 0.999)
EPS = 1e-8


class ReferenceStep:
    """:param options: the recipe (``DynamoConfig`` field names), with
    ``batch_size``; :param phase: a key of ``PHASE_SPEC``;
    :param steps_per_epoch: for the loss-weight ramp and the schedule.
    The model is built on ``device`` with torch's initial values: load the
    weights with ``model.load_state_dict``."""

    def __init__(self, options: dict, phase: str, steps_per_epoch: int, drop_path_rate: float, device):
        self.cfg = SimpleNamespace(**options)
        cfg = self.cfg
        with torch.device(device):
            self.model = DynamoModel(depth_model=cfg.depth_model, encoder_num_layers=cfg.encoder_num_layers,
                                     scales=tuple(cfg.scales), frame_ids=tuple(cfg.frame_ids),
                                     drop_path_rate=drop_path_rate)
        self.bool_cmp, self.bool_mask, self.networks, lr_factor = PHASE_SPEC[phase]
        self.automask = phase == "disp_init"
        self.steps_per_epoch = steps_per_epoch
        self.base_lr = cfg.learning_rate * lr_factor
        trainable = modules_for_networks(self.networks)
        for name in MODULE_NAMES:
            getattr(self.model, name).requires_grad_(name in trainable)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.adam = {}  # parameter -> (step, exp_avg, exp_avg_sq)
        self.opt_steps = 0

    def lr_at(self, count: int) -> float:
        epoch = count // max(self.steps_per_epoch, 1)
        return self.base_lr * (0.5 ** (epoch // self.cfg.scheduler_step_size))

    def pyramid(self, batch: Dict) -> Dict:
        """('color', 0, s) by antialiased bicubic halving, clamped."""
        out = dict(batch)
        H, W = self.cfg.height, self.cfg.width
        for scale in self.cfg.scales:
            if scale:
                out[("color", 0, scale)] = resize_bicubic_aa(out[("color", 0, scale - 1)], (H >> scale, W >> scale))
        return out

    def step(self, batch: Dict, generator: torch.Generator, step: int) -> Dict[str, torch.Tensor]:
        """One step on ``batch``; -> the detached losses. The gradients stay
        in ``.grad`` until the next step."""
        cfg = self.cfg
        lr = self.lr_at(self.opt_steps)
        for p in self.params:
            p.grad = None
        self.model.train()
        inputs = self.pyramid(batch)
        outputs = self.model(inputs, bool_CmpFlow=self.bool_cmp, bool_MotMask=self.bool_mask, generator=generator)
        view_synthesis(cfg, inputs, outputs, bool_CmpFlow=self.bool_cmp, bool_MotMask=self.bool_mask,
                       automask=self.automask)
        losses = compute_losses(cfg, inputs, outputs, generator, bool_CmpFlow=self.bool_cmp,
                                bool_MotMask=self.bool_mask, automask=self.automask,
                                trainable_networks=self.networks, step_in_phase=step,
                                steps_per_epoch=self.steps_per_epoch)
        losses["loss"].backward()
        self._adam(lr)
        self.opt_steps += 1
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def _adam(self, lr: float) -> None:
        """Adam as ``torch.optim.Adam`` computes it; a parameter with no
        gradient is left as it is."""
        b1, b2 = BETAS
        for p in self.params:
            if p.grad is None:
                continue
            t, m, v = self.adam.get(p, (0, torch.zeros_like(p), torch.zeros_like(p)))
            t += 1
            m = m + (1 - b1) * (p.grad - m)
            v = b2 * v + (1 - b2) * p.grad * p.grad
            denom = v.sqrt() / math.sqrt(1 - b2 ** t) + EPS
            p -= (lr / (1 - b1 ** t)) * m / denom
            self.adam[p] = (t, m, v)
