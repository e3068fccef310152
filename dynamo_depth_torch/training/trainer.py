"""The curriculum trainer (port of ``dynamo_depth_tpu.training.trainer``,
reference ``Trainer.py:19-756``).

Four phases, ``disp_init``, ``motion_init``, ``mask_init`` and ``fine_tune``
(Trainer.py:466-497). Per phase: the trainable networks of ``PHASE_SPEC``,
the other modules frozen (their parameters take no gradient and no update;
their BatchNorm statistics still follow the batches, as in the JAX package,
whose frozen modules are applied with ``train=True``), a fresh Adam (eps
1e-8, the update optax.adam makes) with the step-halving learning-rate
schedule over the epoch loader's length, and the automask in ``disp_init``
only. Each epoch draws its training files anew (Trainer.py:519-522), batches
come from the host loader one ahead of the step, the colour pyramid is built
on the device, and every ``log_frequency`` steps the losses are logged, the
step's batch is rendered as the 3x3 training visualisation (with wandb, as
the JAX package's ``log_vis``) and one validation batch is scored. Each
epoch ends with a checkpoint folder in the reference's layout
(``training/checkpoint.py``).

Under a torchrun launch (``parallel/dist.py``) the trainer is data-parallel
with the semantics of the JAX package's ``shard_map`` step: one card per
process, ``batch_size`` rows per process, each process loading its own shard
of every global batch; gradients averaged by ``DistributedDataParallel``,
and after each optimizer step the BatchNorm running statistics of every
module and the losses averaged over the ranks (``pmean``). Each rank
normalises with its own rows' batch statistics, as each JAX device does (no
``SyncBatchNorm``). Rank 0 alone prints and writes.
"""

from __future__ import annotations

import os
import os.path as osp
import subprocess
import time
import zipfile
from typing import Dict, List, Optional

import numpy as np
import torch

from dynamo_depth_torch.config import DynamoConfig
from dynamo_depth_torch.data.loader import BatchLoader, make_dataset, sample_epoch_filenames
from dynamo_depth_torch.data.splits import read_split, split_exists
from dynamo_depth_torch.models.litemono import DilatedConv
from dynamo_depth_torch.models.model import MODULE_NAMES, DynamoModel, modules_for_networks
from dynamo_depth_torch.models.pretrained import MODEL_ZOO, load_pretrained_backbones
from dynamo_depth_torch.ops.metrics import DEPTH_METRIC_NAMES, depth_metrics
from dynamo_depth_torch.ops.warp import resize_bicubic_aa
from dynamo_depth_torch.parallel import dist as pdist
from dynamo_depth_torch.training import checkpoint as ckpt
from dynamo_depth_torch.training.losses import compute_losses, view_synthesis
from dynamo_depth_torch.utils.io import join_dir, sec_to_hm_str
from dynamo_depth_torch.utils.spans import span
from dynamo_depth_torch.utils.vis import hsv_to_rgb, vis_motion

PHASES = ("disp_init", "motion_init", "mask_init", "fine_tune")

# Phase -> (bool_CmpFlow, bool_MotMask, trainable networks, lr factor)
# (Trainer.py:466-490).
PHASE_SPEC = {
    "disp_init": (False, False, ("Depth", "Pose"), 1.0),
    "motion_init": (True, False, ("CmpFlow",), 1.0),
    "mask_init": (True, True, ("Pose", "CmpFlow", "MotMask"), 1.0),
    "fine_tune": (True, True, ("Depth", "Pose", "CmpFlow", "MotMask"), 0.5),
}

# Keys of a host batch that the step does not read.
_HOST_ONLY = {"index", "gt_dim", "sem_mask", "mot_mask", "depth_gt", "depth_valid"}


def resolve_device(device: Optional[str]) -> torch.device:
    """The card unless the caller asks for the CPU; raises without a card.
    The default card is the process's own under torchrun (``LOCAL_RANK``);
    a card given without an index is the current one."""
    if device is None or str(device).startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        dev = torch.device(device or f"cuda:{pdist.local_rank()}")
        return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _to_layout(key, t: torch.Tensor) -> torch.Tensor:
    """Images (B, H, W, 3) -> (B, 3, H, W) contiguous; the kernels read NCHW."""
    if isinstance(key, tuple) and key[0] in ("color", "color_aug"):
        return t.permute(0, 3, 1, 2).contiguous()
    return t


class Trainer:
    """Model, the optimizer of the current phase, the step and the curriculum.

    :param cfg: the run's config (``weights_init="pretrained"`` loads the
        ImageNet backbones found under ``./ckpt``, unless ``load_ckpt`` is
        given)
    :param device: ``"cuda"`` (default: the process's card) or ``"cpu"``
    :param phase: the phase :meth:`train_step` runs until :meth:`train` or
        :meth:`setup_phase` sets another
    :param steps_per_epoch: steps of one epoch of that phase, for the
        loss-weight ramp and the learning-rate schedule (defaults to
        ``cfg.epoch_size``; :meth:`run_phase` uses its loader's length)
    :param drop_path_rate: LiteMono stochastic depth (0.4 in the reference)
    """

    def __init__(self, cfg: DynamoConfig, device: Optional[str] = None, phase: str = "fine_tune",
                 steps_per_epoch: Optional[int] = None, drop_path_rate: float = 0.4):
        self.rank, self.world = pdist.rank(), pdist.world_size()
        cfg.validate(self.world)
        self.cfg = cfg
        self.device = resolve_device(device)
        # The JAX package runs float32 models at Precision.HIGHEST; on the
        # card that means no TF32 in cuDNN convolutions or cuBLAS matmuls.
        # These are process-wide switches, off under bfloat16 too: what runs
        # outside the autocast region (geometry, RANSAC, losses) stays float32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.B, self.H, self.W = cfg.batch_size, cfg.height, cfg.width  # B rows per process
        self.global_B = self.B * self.world
        self.log_path = osp.join(cfg.log_dir, cfg.model_name)

        # The JAX package's random init, drawn on the CPU from the seed: the
        # same weights on the card and the CPU, and in every process
        # (models/init.py). Under a process group every rank then takes rank
        # 0's draw, as the JAX package replicates one init.
        self.model = DynamoModel(
            depth_model=cfg.depth_model, encoder_num_layers=cfg.encoder_num_layers,
            scales=tuple(cfg.scales), frame_ids=tuple(cfg.frame_ids), drop_path_rate=drop_path_rate,
            generator=torch.Generator().manual_seed(cfg.seed),
        ).to(self.device)
        pdist.broadcast_state(self.model)
        if cfg.load_ckpt:
            self.load_model()
        elif cfg.weights_init == "pretrained":
            # ImageNet backbones from ./ckpt where the files are present
            # (resnet_encoder.py:46-49, model.py:25); random init where not.
            load_pretrained_backbones(self.model, cfg, verbose=pdist.is_main_process(), seed=cfg.seed)
        pdist.check_replicated(self.model)
        # Drop-path masks, RANSAC hypotheses and the automask noise: distinct
        # draws on each rank (the JAX step's fold_in(rng, axis_index)), and
        # rank 0's those of one process.
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + (self.rank << 32))
        self._copy_stream = None
        self._wandb = None  # the wandb module once setup_logging has started a run
        self._vis_ranks = False  # under a process group: rank 0 visualises (setup_logging)
        self.g_step = 0
        # One entry per log_time / log_scalars call: what a run reports.
        self.history: List[Dict] = []
        self.setup_phase(phase, steps_per_epoch or max(cfg.epoch_size, 1))

    # ------------------------------------------------------------ phases

    def setup_phase(self, phase: str, steps_per_epoch: int) -> None:
        """Freeze the modules outside the phase's networks and start a fresh
        Adam over the others (and, under a process group, a fresh
        ``DistributedDataParallel`` wrapper: it registers the parameters that
        take a gradient when it is built)."""
        self.phase = phase
        self.bool_cmp, self.bool_mask, self.networks, lr_factor = PHASE_SPEC[phase]
        self.automask = phase == "disp_init"
        self.steps_per_epoch = steps_per_epoch
        self.base_lr = self.cfg.learning_rate * lr_factor
        self.trainable_modules = modules_for_networks(self.networks)
        self.model.zero_grad(set_to_none=True)
        for name in MODULE_NAMES:
            getattr(self.model, name).requires_grad_(name in self.trainable_modules)
        params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.Adam(params, lr=self.lr_at(0), betas=(0.9, 0.999), eps=1e-8)
        self.opt_steps = 0
        self.ddp = None  # built by the phase's first train_step

    def _train_net(self) -> torch.nn.Module:
        """What the training forward runs through: the model, or under a
        process group its ``DistributedDataParallel`` wrapper, whose bucketed
        all-reduce averages the gradients (the JAX step's ``pmean(grads)``).
        Buffers are not broadcast from rank 0: :meth:`_average_batch_stats`
        averages them. The LayerNorms ``DilatedConv.norm`` of LiteMono are
        never used by its forward (nor by the reference's): in a phase that
        trains them DDP looks for unused parameters after every forward, or
        it would stop at the phase's second step."""
        if not pdist.is_initialized():
            return self.model
        if self.ddp is None:
            from torch.nn.parallel import DistributedDataParallel

            unused = any(p.requires_grad for m in self.model.modules() if isinstance(m, DilatedConv)
                         for p in m.norm.parameters())
            self.ddp = DistributedDataParallel(
                self.model, device_ids=[self.device.index] if self.device.type == "cuda" else None,
                broadcast_buffers=False, find_unused_parameters=unused, init_sync=False)
        return self.ddp

    def _average_batch_stats(self) -> None:
        """Average every BatchNorm running statistic of every module, frozen
        ones included, over the ranks, in one all-reduce (the JAX step's
        ``pmean`` of ``batch_stats``; DDP's ``broadcast_buffers`` would copy
        rank 0's instead)."""
        pdist.all_reduce_mean([b for name, b in self.model.named_buffers() if name.endswith(("running_mean", "running_var"))])

    def lr_at(self, count: int) -> float:
        """Step-halving schedule: base * 0.5 ** (epoch // scheduler_step_size)."""
        epoch = count // max(self.steps_per_epoch, 1)
        return self.base_lr * (0.5 ** (epoch // self.cfg.scheduler_step_size))

    # -------------------------------------------------------------- data side

    def process_inputs_device(self, inputs: Dict) -> Dict:
        """Colour pyramid ('color', 0, s) by recursive antialiased bicubic
        halving with clamping (Trainer.py:729-734), on the device."""
        out = dict(inputs)
        with span("dynamo.pyramid"):
            for scale in self.cfg.scales:
                if scale == 0:
                    continue
                h, w = self.H // (2 ** scale), self.W // (2 ** scale)
                out[("color", 0, scale)] = resize_bicubic_aa(out[("color", 0, scale - 1)], (h, w))
        return out

    def get_dataset(self, filenames, is_train=False, load_depth=False, load_mask=False, img_type=None):
        return make_dataset(self.cfg, filenames, is_train=is_train, load_depth=load_depth, load_mask=load_mask,
                            img_type=img_type)

    def _copy_async(self, batch: Dict):
        """Queue the copy of a host batch to the device; -> (tensors, event
        that marks the copy done, or None where nothing is asynchronous)."""
        batch = {k: v for k, v in batch.items() if k not in _HOST_ONLY}
        if self.device.type != "cuda":
            return {k: _to_layout(k, torch.as_tensor(np.asarray(v))) for k, v in batch.items()}, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        out = {}
        with torch.cuda.stream(self._copy_stream):
            for k, v in batch.items():
                host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                out[k] = _to_layout(k, host.to(self.device, non_blocking=True))
        done = torch.cuda.Event()
        done.record(self._copy_stream)
        return out, done

    def _ready(self, tensors: Dict, done) -> Dict:
        """Make the current stream wait for the copy, and keep the copy
        stream's memory from being reused while the current stream reads it."""
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in tensors.values():
                t.record_stream(stream)
        return tensors

    def to_device(self, batch: Dict) -> Dict:
        """A host batch (numpy; images (B, H, W, 3), as the loader and
        ``synthetic_batch`` give them) -> the step's tensors on the device,
        images (B, 3, H, W) contiguous, host-only keys dropped."""
        return self._ready(*self._copy_async(batch))

    def _prefetch(self, loader):
        """Device batches from ``loader``, each copied while the step before
        it runs: pinned host memory, a copy stream one batch ahead."""
        pending = None
        for batch in loader:
            copied = self._copy_async(batch)
            if pending is not None:
                yield self._ready(*pending)
            pending = copied
        if pending is not None:
            yield self._ready(*pending)

    def _make_train_loader(self, epoch_seed: int) -> BatchLoader:
        """This rank's batches of the epoch: the epoch's draw of global
        batches (the same on every rank), each rank loading every
        ``world``-th batch of ``B`` rows (the JAX package's per-host shards)."""
        filenames = sample_epoch_filenames(read_split(self.cfg.split, "train"), self.cfg.epoch_size, self.global_B,
                                           seed=epoch_seed)
        return BatchLoader(
            make_dataset(self.cfg, filenames, is_train=True), self.B, shuffle=self.cfg.epoch_size <= 0, drop_last=True,
            num_workers=self.cfg.num_workers, seed=self.cfg.seed, shard=(self.rank, self.world),
            prefetch=self.cfg.prefetch_depth,
        )

    def _make_val_loader(self) -> BatchLoader:
        which = "val" if split_exists(self.cfg.split, "val") else "train"
        ds = make_dataset(self.cfg, read_split(self.cfg.split, which), load_depth=True)
        return BatchLoader(ds, self.B, shuffle=True, drop_last=True, num_workers=self.cfg.num_workers,
                           seed=self.cfg.seed + 1, shard=(self.rank, self.world))

    # ------------------------------------------------------------ train step

    def _model_outputs(self, inputs: Dict, bool_CmpFlow: bool, bool_MotMask: bool, generator=None, net=None) -> Dict:
        """The networks' forward in the compute dtype, every output float32.

        Under ``compute_dtype="bfloat16"`` the networks run inside
        ``torch.autocast`` (parameters, BatchNorm statistics and Adam's state
        stay float32), and the region ends at the model's outputs, which are
        cast to float32 as the JAX package's ``_outputs_to_f32`` casts them:
        the sample coordinates, the warp and photometric kernels, RANSAC and
        the losses see float32 only. ``net`` is the model (default) or its
        training wrapper."""
        net = net or self.model
        if self.compute_dtype == torch.float32:
            return net(inputs, bool_CmpFlow=bool_CmpFlow, bool_MotMask=bool_MotMask, generator=generator)
        with torch.autocast(device_type=self.device.type, dtype=self.compute_dtype):
            outputs = net(inputs, bool_CmpFlow=bool_CmpFlow, bool_MotMask=bool_MotMask, generator=generator)
        return {k: v.float() if v.is_floating_point() else v for k, v in outputs.items()}

    def _forward_losses(self, inputs: Dict, generator: torch.Generator, step: int, net=None):
        """The model's outputs and the losses of the rows of ``inputs``."""
        with span("dynamo.networks"):
            outputs = self._model_outputs(inputs, self.bool_cmp, self.bool_mask, generator, net)
        with span("dynamo.view_synthesis"):
            view_synthesis(self.cfg, inputs, outputs, bool_CmpFlow=self.bool_cmp, bool_MotMask=self.bool_mask,
                           automask=self.automask)
        with span("dynamo.losses"):
            losses = compute_losses(
                self.cfg, inputs, outputs, generator,
                bool_CmpFlow=self.bool_cmp, bool_MotMask=self.bool_mask, automask=self.automask,
                trainable_networks=self.networks, step_in_phase=step, steps_per_epoch=self.steps_per_epoch,
            )
        return outputs, losses

    def train_step(self, batch: Dict, generator: torch.Generator, step: int) -> Dict[str, torch.Tensor]:
        """One optimizer step of the current phase on ``batch`` (tensors on
        the device, from :meth:`to_device`). ``generator`` (on the device)
        draws drop-path masks, RANSAC hypotheses and the automask noise;
        ``step`` is the step within the phase (loss-weight ramp). Returns
        the detached losses dict of ``compute_losses``, averaged over the
        ranks under a process group (each rank's ``batch`` is its own rows).
        The step's spans (``utils/spans.py``) are ``dynamo.train_step``,
        carrying ``step``, and inside it ``dynamo.pyramid``,
        ``dynamo.networks``, ``dynamo.view_synthesis``, ``dynamo.losses``
        (holding ``dynamo.ground_plane``), ``dynamo.backward``,
        ``dynamo.optimizer`` and ``dynamo.batch_stats``."""
        with span("dynamo.train_step", step):
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_at(self.opt_steps)
            self.optimizer.zero_grad(set_to_none=True)
            self.model.train()
            # Neither the outputs nor the losses keep the graph past the root
            # span: freeing it is part of the step's host time.
            losses = self._forward_losses(self.process_inputs_device(batch), generator, step, self._train_net())[1]
            with span("dynamo.backward"):
                losses["loss"].backward()
            with span("dynamo.optimizer"):
                self.optimizer.step()
            self.opt_steps += 1
            with span("dynamo.batch_stats"):
                self._average_batch_stats()
            losses = self._average_losses(losses)
        return losses

    def _average_losses(self, losses: Dict) -> Dict:
        """Detached losses, averaged over the ranks: every rank scores the
        same number of rows, so their mean is the global batch's."""
        losses = {k: v.detach() for k, v in losses.items()}
        if self.world > 1:
            losses = {k: v.clone() for k, v in losses.items()}
            pdist.all_reduce_mean(list(losses.values()))
        return losses

    # -------------------------------------------------------------- training

    def train(self):
        """Run the four-phase curriculum (Trainer.py:90-106)."""
        self.setup_logging()
        self.g_step = 0
        for phase_i, phase in enumerate(PHASES):
            num_epoch = self.cfg.epoch_schedules[phase_i]
            self.print(f"======== {phase.upper()} - Num Epochs={num_epoch} ========")
            if num_epoch > 0:
                self.run_phase(phase, num_epoch)
            self.print(f"======== {phase.upper()} - Num Epochs={num_epoch} ========\n")

    def run_phase(self, phase: str, num_epoch: int):
        cfg = self.cfg
        steps_per_epoch = len(self._make_train_loader(epoch_seed=cfg.seed))
        self.setup_phase(phase, steps_per_epoch)
        if cfg.resume_optim and cfg.load_ckpt:
            # The reference saves adam.pth but never reloads it
            # (Trainer.py:706-707); the JAX package restores it when asked.
            self.load_optimizer(osp.expanduser(cfg.load_ckpt))

        self.step = 0
        self.num_total_steps = steps_per_epoch * num_epoch
        self.start_time = time.time()
        self._val_iter = None
        prof = None
        if cfg.profile and pdist.is_main_process():
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        try:
            for epoch in range(num_epoch):
                self.epoch = epoch
                self.print()
                loader = self._make_train_loader(epoch_seed=cfg.seed + 1000 * epoch + 101 * PHASES.index(phase))
                loader.set_epoch(epoch)
                data_t, step_t = 0.0, 0.0
                t0 = time.time()
                for batch_idx, batch in enumerate(self._prefetch(loader)):
                    data_t += time.time() - t0
                    t0 = time.time()
                    losses = self.train_step(batch, self.generator, self.step)
                    late_freq = 10 * cfg.log_frequency
                    if (batch_idx % cfg.log_frequency == 0 and self.step < late_freq) or self.step % late_freq == 0:
                        loss_val = float(losses["loss"])
                        self.log_time(batch_idx, max(time.time() - t0, 1e-9), loss_val, data_t, step_t)
                        data_t, step_t = 0.0, 0.0
                        self.log_scalars("train", losses)
                        self.log_vis("train", batch)
                        self.val()
                    step_t += time.time() - t0
                    self.g_step += 1
                    self.step += 1
                    t0 = time.time()
                if (epoch + 1) % cfg.save_frequency == 0 or epoch == num_epoch - 1:
                    self.save_model(phase, epoch)
        finally:
            self._val_iter = None
            if prof is not None:
                prof.stop()
                prof.export_chrome_trace(osp.join(join_dir(self.log_path, "traces", phase), "trace.json"))

    def val(self):
        """Score one validation batch for training monitoring (Trainer.py:175-195;
        val is never used for model selection): eval mode, no gradients, the
        losses and, where the batch has LiDAR points, the depth metrics.

        Under a process group the ranks' rows are gathered and rank 0 scores
        the global batch, as the JAX package's validation step (one jit over
        the global batch) does, so that the terms that couple the rows see
        all of them: m_sparsity's static threshold ``mean(disp_mag)``, its
        normaliser and ``all_have_static``, the RANSAC pairing under
        ``gp_score_mode="reference"``, and the warp's dtype knee. In eval
        mode a row's outputs do not depend on the other rows. Rank 0 draws
        the RANSAC hypotheses and the automask noise from its own generator,
        as one process does; the other ranks draw nothing and log the scores
        rank 0 broadcasts, so every rank logs the same values."""
        try:
            if self._val_iter is None:
                self._val_loader = self._make_val_loader()
                self._val_iter = iter(self._val_loader)
            try:
                batch = next(self._val_iter)
            except StopIteration:
                self._val_iter = iter(self._val_loader)
                batch = next(self._val_iter)
        except (FileNotFoundError, StopIteration):
            return  # no validation data
        if self.world > 1:
            batch = self._gather_rows(batch)
        scores = None
        if pdist.is_main_process():
            self.model.eval()
            try:
                with torch.no_grad():
                    outputs, losses = self._forward_losses(
                        self.process_inputs_device(self.to_device(batch)), self.generator, self.step)
                    scores = {k: v.detach() for k, v in losses.items()}
                    if "depth_gt" in batch:
                        scores.update(self.depth_metrics(batch, outputs, over_ranks=False))
            finally:
                self.model.train()
        if self.world > 1:
            shared = pdist.broadcast_object(None if scores is None else {k: float(v) for k, v in scores.items()})
            scores = {k: torch.tensor(v) for k, v in shared.items()}
        self.log_scalars("val", scores)

    def _gather_rows(self, batch: Dict) -> Dict:
        """Every rank's rows of a host batch in rank order, the global batch
        (numpy): the keys the step reads and the depth metrics' LiDAR keys."""
        keys = sorted((k for k in batch if k not in _HOST_ONLY or k in ("depth_gt", "depth_valid", "gt_dim")), key=str)
        return {k: pdist.all_gather_rows(torch.as_tensor(np.asarray(batch[k]))).numpy() for k in keys}

    def depth_metrics(self, inputs: Dict, outputs: Dict, mask_pts=None, labels=None, sample_weight=None,
                      over_ranks: bool = True) -> Dict:
        """Sparse-point depth metrics of ``outputs[('disp_scaled', 0, 0)]``
        against the host batch's LiDAR points, on the device; with ``labels``,
        also per mask label of ``mask_pts`` (the labels at the points), and
        ``sample_weight`` drops padded samples (``ops/metrics.py``). Under a
        process group ``inputs`` and ``outputs`` hold this rank's rows, and
        the metrics are the global batch's: the weighted sums and the counts
        are summed over the ranks, then divided. ``over_ranks=False``
        scores the rows given alone (validation's global batch)."""
        cfg = self.cfg
        out = depth_metrics(
            outputs[("disp_scaled", 0, 0)], inputs["depth_gt"], inputs["depth_valid"], inputs["gt_dim"],
            cfg.eval_img_bound, min_depth=cfg.eval_min_depth, max_depth=float(cfg.eval_max_depth),
            mask_pts=mask_pts, labels=labels, sample_weight=sample_weight,
        )
        if self.world == 1 or not over_ranks:
            return out
        weight = torch.ones(len(inputs["depth_gt"])) if sample_weight is None else torch.as_tensor(sample_weight)
        count = weight.float().sum().to(outputs[("disp_scaled", 0, 0)].device)
        pairs = [k for k in out if k not in DEPTH_METRIC_NAMES]  # per label: (sum of metric x count, count)
        n = len(DEPTH_METRIC_NAMES)
        # ops/metrics.py divides each weighted sum by max(count, 1).
        flat = torch.cat([torch.stack([out[k] for k in DEPTH_METRIC_NAMES]) * count.clamp(min=1.0), count.reshape(1)]
                         + [torch.stack(out[k]) for k in pairs])
        pdist.all_reduce_sum([flat])
        reduced = {k: flat[i] / flat[n].clamp(min=1.0) for i, k in enumerate(DEPTH_METRIC_NAMES)}
        reduced.update({k: (flat[n + 1 + 2 * j], flat[n + 2 + 2 * j]) for j, k in enumerate(pairs)})
        return reduced

    # --------------------------------------------------------------- predict

    def predict(self, batch: Dict, bool_CmpFlow=False, bool_MotMask=False) -> Dict:
        """Eval-mode forward of the ``('color_aug', f, 0)`` images of a host
        batch, for the eval CLIs (the JAX package's ``Trainer.predict``):
        running BatchNorm statistics, no drop-path, no gradients. Returns the
        model's outputs on the device, images NCHW; the model's mode is
        restored afterwards. Under a process group each rank predicts its own
        rows."""
        images = {k: v for k, v in batch.items() if isinstance(k, tuple) and k[0] == "color_aug"}
        if not images:
            raise ValueError("predict() needs ('color_aug', <frame>, 0) keys in the batch; none were present")
        inputs = self.to_device(images)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                return self._model_outputs(inputs, bool_CmpFlow, bool_MotMask)
        finally:
            self.model.train(was_training)

    # -------------------------------------------------------------------- io

    def save_model(self, phase: str, epoch: int):
        """``models/<phase>_<epoch:02>/``: the seven module files, ``adam.pth``
        and the run's ``opt.json``, written by rank 0 (the bare model's keys,
        the reference's); every rank waits until it is written."""
        if pdist.is_main_process():
            folder = join_dir(self.log_path, "models", f"{phase}_{epoch:02}")
            ckpt.save_model(self.model, folder, height=self.H, width=self.W, verbose=True)
            ckpt.save_opt_state(self.optimizer, folder)
            self.cfg.save(osp.join(folder, "opt.json"))
        pdist.barrier()

    def load_model(self):
        path = osp.expanduser(self.cfg.load_ckpt)
        if not osp.isdir(path):
            path = self._try_fetch_zoo_ckpt(path)
        if not osp.isdir(path):
            raise FileNotFoundError(f"Cannot find checkpoint folder {path}")
        self.print(f"loading model from folder {path}")
        ckpt.load_model(self.model, path, height=self.H, width=self.W, verbose=pdist.is_main_process())

    def _try_fetch_zoo_ckpt(self, path: str) -> str:
        """Released-checkpoint download (model.py:210-222), as the JAX
        package's: where ``path`` names a :data:`MODEL_ZOO` entry, one
        ``gdown <id>`` and the unzip into ``ckpt/<name>``; otherwise a
        ``FileNotFoundError`` that says what to fetch. Rank 0 fetches, the
        other ranks wait for it and raise with it."""
        if path not in MODEL_ZOO:
            return path
        gdrive_id = MODEL_ZOO[path]
        if gdrive_id is None:
            raise FileNotFoundError(
                f"{path} is Waymo-licensed; request access per the reference README "
                "and place the unzipped folder at that path.")
        self.print(f"Missing model checkpoint {path}, attempting download.")
        error = None
        if pdist.is_main_process():
            name = path.split("/")[1]
            os.makedirs("./ckpt/", exist_ok=True)
            try:
                subprocess.run(["gdown", gdrive_id], check=True, timeout=600)
                # The standard library's zipfile in place of the JAX package's
                # `unzip -o`: the same files land.
                with zipfile.ZipFile(f"{name}.zip") as archive:
                    archive.extractall(".")
                os.replace(name, f"ckpt/{name}")
                os.remove(f"{name}.zip")
            except Exception as e:  # any failure of the fetch: say what to fetch by hand
                error = e
        if pdist.any_rank(error is not None):
            raise FileNotFoundError(
                f"Could not auto-download {path} ({error or 'the download failed on rank 0'}). Download the "
                f"reference checkpoint (gdrive id {gdrive_id}), unzip to {path}, and re-run; "
                "the torch .pth files are read as they are.")
        return path

    def load_optimizer(self, folder: str) -> None:
        """Restore the folder's ``adam.pth`` (or a JAX folder's
        ``adam.msgpack``) into the current phase's Adam,
        and with it the step count that drives the learning-rate schedule."""
        if ckpt.load_opt_state(self.optimizer, folder, self.model):
            self.opt_steps = max((int(s["step"]) for s in self.optimizer.state.values()), default=0)
            self.print(f"restored optimizer state from {folder}")

    def save_opt(self):
        if not pdist.is_main_process():
            return
        models_dir = join_dir(self.log_path, "models")
        if self.cfg.print_opt:
            for k, v in self.cfg.to_dict().items():
                print("{:30}{}".format(k + ":", v))
        self.cfg.save(osp.join(models_dir, "opt.json"))

    # --------------------------------------------------------------- logging

    def setup_logging(self):
        """Write ``opt.json`` and, unless ``--no_train_vis``, start a wandb
        run (the JAX package's ``setup_logging``). Where wandb does not
        import or its ``init`` fails the run trains on without it; on a
        machine with no network wandb's own ``WANDB_MODE=offline`` keeps the
        run on disk. Under a process group the visualisation runs where
        rank 0's wandb started, on every rank (:meth:`log_vis`)."""
        self.save_opt()
        self._wandb = None
        if not self.cfg.no_train_vis:
            try:
                import wandb

                wandb.init(project="Dynamo", name=self.cfg.model_name, notes=self.cfg.comment,
                           config=self.cfg.to_dict())
                self._wandb = wandb
            except Exception as e:  # any failure: train on without wandb, as the JAX package does
                self.print(f"wandb not started ({e!r}): training without the visualisation")
        # log_vis takes its maxima over the ranks: every rank follows rank
        # 0's answer, so that all of them enter the reduction together.
        self._vis_ranks = pdist.broadcast_object(self._wandb is not None)

    def log_scalars(self, mode: str, losses: Dict):
        """Keep the 0-d entries of ``losses`` as floats in :attr:`history`,
        and log them to wandb as ``{mode}_{key}`` at ``g_step``."""
        scalars = {k: v for k, v in losses.items() if torch.is_tensor(v) and v.ndim == 0}
        values = torch.stack([v.float() for v in scalars.values()]).tolist() if scalars else []
        self.history.append({"mode": mode, "phase": self.phase, "g_step": self.g_step,
                             "scalars": dict(zip(scalars, values))})
        if self._wandb is None:
            return
        try:
            self._wandb.log({f"{mode}_{k}": v for k, v in zip(scalars, values)}, step=self.g_step)
        except Exception as e:  # a logging failure does not stop the run, as in the JAX package
            self.print(f"wandb.log failed: {e!r}")

    def _vis_panels(self, batch: Dict) -> Dict:
        """The visualisation's forward of ``batch`` (this rank's rows) and
        its panels on the host, NHWC: the L1 error over its largest value
        and the three colour wheels valued by their magnitude over the
        largest of the three, both maxima taken over the ranks (the JAX
        package takes them over the global batch, ``log_vis``). The bare
        model runs in eval mode with no graph, with the phase's flags; every
        module's mode is restored afterwards."""
        cfg = self.cfg
        inputs = self.process_inputs_device(batch)
        modes = {m: m.training for m in self.model.modules()}
        self.model.eval()
        try:
            with torch.no_grad():
                outputs = self._model_outputs(inputs, self.bool_cmp, self.bool_mask)
                # The knee counts the global batch, as the JAX ``vis_step``.
                view_synthesis(cfg, inputs, outputs, bool_CmpFlow=self.bool_cmp, bool_MotMask=self.bool_mask,
                               automask=self.automask, shards=self.world)
        finally:
            for m, training in modes.items():
                m.training = training
        f = cfg.frame_ids[1]

        def host(t):  # NCHW on the device -> NHWC numpy
            return t.permute(0, 2, 3, 1).float().cpu().numpy()

        color, recon = host(inputs[("color", 0, 0)]), host(outputs[("color", f, 0)])
        depth, flow = host(outputs[("depth", 0, 0)]), host(outputs[("independ_flow", f, 0)])
        K, inv_K = inputs[("K", 0)].cpu().numpy(), inputs[("inv_K", 0)].cpu().numpy()
        T = outputs[("cam_T_cam", 0, f)].float().cpu().numpy()

        l1 = np.abs(color - recon).mean(-1, keepdims=True)
        wheels = [vis_motion(depth, K, inv_K, motion_map=m, camTcam=t) for m, t in ((None, T), (flow, None), (flow, T))]
        l1_max, mags = l1.max(), [mag for _, mag in wheels]
        if self.world > 1:
            peaks = pdist.all_reduce_max([torch.tensor([float(l1_max), *mags], dtype=torch.float64,
                                                       device=self.device)])[0].tolist()
            l1_max, mags = np.float32(peaks[0]), peaks[1:]
        l1 = l1 / (l1_max + 1e-6)
        max_mag = max(mags)
        for hsv, mag in wheels:  # hsv's value is |m| over this rank's own magnitude
            hsv[..., 2] = np.clip(hsv[..., 2] * mag / max_mag, 0, 1)
        return {"color": color, "recon": recon, "l1": l1, "disp": host(outputs[("disp", 0, 0)]),
                "mask": host(outputs[("motion_mask_r", f, 0)]), "depth": depth, "wheels": [h for h, _ in wheels]}

    def vis_grids(self, batch: Dict) -> np.ndarray:
        """The 3x3 training-visualisation grid of each sample of ``batch``
        (device tensors, from :meth:`to_device`), (min(B, rows), 3H, 3W, 3)
        float32 in [0, 1] on the host (Trainer.py:607-654; the JAX package's
        ``vis_step`` and ``log_vis``): [rgb | reconstruction from frame
        ``frame_ids[1]`` | L1 / max L1 over the batch], [disparity | motion
        mask | depth / max depth], and the ego, independent and total flow
        colour wheels, valued by their magnitude over the largest of the
        three (:meth:`_vis_panels`; under a process group the maxima are
        the global batch's, and every rank must call this together)."""
        p = self._vis_panels(batch)
        color, recon, l1, disp, mask, depth = (p[k] for k in ("color", "recon", "l1", "disp", "mask", "depth"))
        ego, ind, tot = (1 - hsv_to_rgb(hsv) for hsv in p["wheels"])

        def rep3(x):
            return np.repeat(x, 3, axis=-1)

        grids = []
        for j in range(min(color.shape[0], self.B)):
            rows = [np.concatenate([color[j], recon[j], rep3(l1[j])], axis=1),
                    np.concatenate([rep3(disp[j]), rep3(mask[j]), rep3(depth[j] / depth[j].max())], axis=1),
                    np.concatenate([ego[j], ind[j], tot[j]], axis=1)]
            grids.append(np.clip(np.concatenate(rows, axis=0), 0, 1))
        return np.stack(grids)

    def log_vis(self, mode: str, batch: Dict):
        """Log :meth:`vis_grids` of ``batch`` to wandb, one image
        ``vis/{mode}_{j}`` per sample, at ``g_step``, where wandb is on.
        Under a process group every rank runs the forward of its own rows,
        because the panels' maxima are reduced over the ranks; rank 0 alone
        renders its rows and logs them, as both packages render the global
        batch's first ``B`` rows. Whether it runs there is rank 0's answer,
        taken once by :meth:`setup_logging`, so every rank enters the
        reduction at the same steps."""
        if self.world > 1:
            if not self._vis_ranks:
                return
            if not pdist.is_main_process():
                self._vis_panels(batch)
                return
        elif self._wandb is None or self.cfg.no_train_vis:
            return
        package = {f"vis/{mode}_{j}": self._wandb.Image(grid) for j, grid in enumerate(self.vis_grids(batch))}
        try:
            self._wandb.log(package, step=self.g_step)
        except Exception as e:  # a logging failure does not stop the run, as in the JAX package
            self.print(f"wandb.log failed: {e!r}")

    def log_time(self, batch_idx, duration, loss, data_time, step_time):
        """Print the step's rate and the time since the last line, split into
        the wait for the loader's batches (``data_time``) and the host time of
        the calls between them (``step_time``: ``train_step`` and the logging,
        timed without a synchronisation, so not the card's time)."""
        if not pdist.is_main_process():
            return
        samples_per_sec = self.global_B / duration
        time_sofar = time.time() - self.start_time
        left = (self.num_total_steps / self.step - 1.0) * time_sofar if self.step > 0 else 0
        self.history.append({"mode": "time", "phase": self.phase, "g_step": self.g_step, "epoch": self.epoch,
                             "batch": batch_idx, "loss": loss, "examples_per_s": samples_per_sec,
                             "data_s": data_time, "compute_s": step_time})
        print(
            f"epoch {self.epoch:>3} | batch {batch_idx:>6} | examples/s: {samples_per_sec:5.1f} "
            f"| loss: {loss:.5f} | time elapsed: {sec_to_hm_str(time_sofar)} "
            f"| time left: {sec_to_hm_str(left)} | data wait/step host time: {data_time:0.1f}s/{step_time:0.1f}s"
        )

    def print(self, s=""):
        if pdist.is_main_process():
            print(s)
