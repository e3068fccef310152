#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, nothing is caught):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the CUDA kernels from ``dynamo_depth_torch/csrc`` (nvcc, one
   process per source, into ``build/kernels``);
3. hold every kernel against its plain PyTorch version (and the warp against
   ``F.grid_sample``) at the main path's shapes: batch 3, 3 channels, 192x640;
   the warp on two grids, a uniform random one (every tap in its own
   cache sector) and a stand-in for a trained model's ego-motion (identity
   plus ego-motion from a smooth 5-80 m depth,
   ``training/synthetic.py::ego_motion_grid``); and at exact ties, where the
   kernels take the JAX package's subgradients as the plain versions do: K4
   where pred equals target on a textured image, K2 on a grid whose entries
   beyond the border are clipped to exactly -1 or 1;
4. time every kernel, its plain version and the one PyTorch call that
   computes the same function where there is one (device time from the
   profiler, and CUDA events around one call) beside its bound: the bytes it
   must move over the card's memory rate, or its operations over the card's
   float32 rate; the warp on both grids, with the ego-motion grid's
   displacement; the kernels and the library calls also with a cold L2
   (a 64 MB buffer overwritten before each call);
5. one ``fine_tune`` step on the card against the same step on the CPU (the
   plain versions) from the same weights at 64x96;
6. the main path: the LiteMono ``fine_tune`` step at 192x640, batch 3,
   float32 (KITTI headline config, random weights from seed 0): 2 warm-up
   and 5 timed steps, finite losses, moving weights, and the launches per
   step of each of the four kernels that ``cfg.scales`` gives (2 source
   frames per scale: 6); then one profiled step, with each kernel's
   own device time inside it; then one more step whose six warp inputs are
   captured and saved to ``build/chip_smoke/step_warp_inputs.pt`` (for
   ``bench/kernel_ab.py --step-inputs``), with each grid's displacement and
   the warp kernels and ``F.grid_sample``'s forward and backward
   (``grid_sampler_2d``) timed alone on them, with a warm and a cold L2;
7. the curriculum from the port's entry point,
   ``dynamo_depth_torch.train.main``, on the vendored ``assets/tiny_kitti``
   (LiteMono, 192x640, batch 3, float32, one epoch of 3 steps per phase, one
   validation batch per step, a split under ``build/chip_smoke``): which
   decoder loaded the images, each phase's kernel launches per step against
   the count that phase must make, finite losses, the trainable modules'
   weights moved and the frozen ones' bit-identical, ms/step and the
   data-wait and compute time of each phase, peak memory, four checkpoint
   folders in the reference's layout, ``fine_tune_00`` loaded into a fresh
   trainer with the same state dict, and one more ``fine_tune`` step from it
   with ``--load_ckpt ... --resume_optim``;
8. the eval path from ``fine_tune_00`` at 192x640, batch 3, through each
   entry point's ``main(..., device=...)``: depth on ``tiny_kitti`` (Part 1)
   and ``tiny_waymo`` (Parts 1 and 2), motion segmentation on ``tiny_waymo``
   (npz and FP tally), odometry on an 8-frame segment built under
   ``build/chip_smoke/data``, visualize on ``tiny_waymo`` and the quick demo
   on ``tiny_nuscenes``'s non-edge frame; all of it again on the CPU, each
   record of the card's held against the CPU's (depth tables to 0.001,
   tp/fp/fn and the FP tally to 1e-3 of the pixels, precision/recall/f1 to
   1e-3, thresholds equal, odometry to 1e-4 relative, frames within one level on
   99.9% of the pixels); no launch of the four kernels during the card's
   run, its peak memory, the plot files written and not written, and
   ``Trainer.predict``'s device ms per batch for each of its three flag
   settings (median of 5 after 2 warm-ups);
9. monodepthv2 (ResNet-18 depth encoder, Monodepth2 decoder, 4 scales):
   the 64x96 step on the card against the CPU as in phase 5; the
   ``fine_tune`` step at 192x640, batch 3, float32, timed as phase 6 with 8
   launches per step of each kernel, and profiled; the curriculum from the
   entry point on tiny_kitti with ``--depth_model monodepthv2``, 2 steps per
   phase (8 launches per step, 16 of K3 in disp_init), checked as phase 7;
   ``eval.depth`` of its ``fine_tune_00`` on the card and the CPU, tables
   compared as in phase 8;
10. bfloat16: the LiteMono ``fine_tune`` step at 192x640, batch 3, with
   ``compute_dtype="bfloat16"`` from phase 6's seed-0 weights: one step
   against a float32 step from the same weights, batch and draws (each loss
   term that RANSAC does not enter within ``BF16_LOSS_TOL``; d_ground and
   the totals finite), then timed and profiled as phase 6 (still
   6 launches per step: the kernels take the float32 outputs), beside phase
   6's numbers; one bfloat16 monodepthv2 step with finite losses;
11. data parallelism over ``torch.distributed``, each launch a subprocess
   ``python -m torch.distributed.run ... chip_smoke.py --ddp-worker <name>
   <dir>`` killed after ``DDP_TIMEOUT_S``: (a) at world size 1 over NCCL,
   the curriculum from the entry point as phase 7 runs it (2 steps per
   phase, the launches per step, weights moved or bit-identical,
   checkpoints) through ``DistributedDataParallel``, its ms/step beside
   phase 7's; (b) two ranks sharing the card over gloo (NCCL refuses two
   ranks on one card): 3 ``fine_tune`` steps at 192x640, batch 3 per rank,
   6 launches of each kernel per rank-step, parameters and BatchNorm
   buffers bit-identical across the ranks after every step, ms/step and
   the bytes all-reduced per step; the same two ranks at 64x96 on the card
   against the two on the CPU, the loss terms RANSAC does not enter at
   phase 5's tolerance (the others recorded); (c) ``eval.depth``
   with the two ranks, its tables equal to phase 8's one-process tables;
12. (a) the training visualisation: the curriculum from the entry point on
   tiny_kitti at 192x640, batch 3, one step per phase, without
   ``--no_train_vis`` and with a recording stand-in for wandb in
   ``sys.modules`` (never the real one: no network): per step 3 grids of
   576x1920x3, finite, in [0, 1], the train and val scalars under the JAX
   package's names, 6 launches of K1 and none of K2-K4 in each ``log_vis``
   call, its wall ms beside the step's; ``vis_grids`` of one batch on the
   card against the CPU from the same weights (``VIS_TOL`` on the first two
   rows, the colour wheels as phase 8 holds frames); (b) phase 7's last
   folder with its Adam state written in the JAX package's ``.msgpack``
   layout: ``eval.depth`` from it equal to phase 8's table, its time beside
   the ``.pth`` folder's, and one ``fine_tune`` step resumed from each
   folder (and once more from the ``.pth`` one, which says how far the
   card's step repeats bitwise): bit-equal losses, the states within one
   Adam step's round-off, and the same two steps bit-equal on the CPU; (c) ``bench/grad_compare.py`` at its
   defaults on the card and the CPU, then ``--diff``: the terms outside
   RANSAC within phase 5's 1e-4, update norms within ``UPDATE_NORM_TOL``;
   (d) ``bench/profile_top_ops.py`` on a ``--profile`` trace of 2
   ``fine_tune`` steps, its counts of the four kernels held to the steps'
   and the validation batches' launches.

Prints one ``{"kernels": [...]}`` line, then, last, the
``{"ok": true, "device": {...}}`` line.
"""

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

B, C, H, W = 3, 3, 192, 640
STEPS_WARMUP, STEPS_TIMED = 2, 5

# Published H100 rates (NVIDIA data sheets): HBM bytes/s and float32 (non
# tensor-core) FLOP/s at the full power limit.
_RATES = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12), "": (3.35e12, 67e12)}


def card_rates(name):
    for key, rates in _RATES.items():
        if key and key in name:
            return rates
    return _RATES[""]


def fmt_ms(v):
    """A device time, or n/a where the profiler saw no device activity."""
    return "n/a" if v is None else f"{v:.4f}"


def mean_ms(values):
    return None if any(v is None for v in values) else float(np.mean(values))


def max_err(a, b):
    return float((a - b).detach().abs().max())


def check(name, err, tol):
    ok = err <= tol
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.1e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")


def launches_per_step(cfg, phase="fine_tune"):
    """Launches of each kernel in one training step of ``phase``: one warp
    and one photometric error per scale and source frame (6 for LiteMono's
    3 scales, 8 for monodepthv2's 4), and in disp_init as many photometric
    forwards again for the identity automask, whose inputs need no gradient."""
    n = len(cfg.scales) * (len(cfg.frame_ids) - 1)
    return {"warp_fwd": n, "warp_bwd": n, "photometric_fwd": 2 * n if phase == "disp_init" else n,
            "photometric_bwd": n}


def run_curriculum(smi, depth_model="litemono", steps=3, name="curriculum", reload=True):
    """Phases 7, 9 and 11a: the curriculum from the entry point, ``steps``
    steps per phase, then (``reload``) its last folder loaded into a fresh
    trainer and one more step from it. Returns {"launches": {kernel: n},
    "per_step": {kernel: {phase: n}}, "summary": {...}, "wrappers": the
    type of the training wrapper at each step}; raises SystemExit on any
    failure."""
    import torch

    from dynamo_depth_torch import train as train_entry
    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.data import base as data_base, native
    from dynamo_depth_torch.models.model import MODULE_NAMES, modules_for_networks
    from dynamo_depth_torch.ops.kernels import launch_counts, reset_launch_counts
    from dynamo_depth_torch.training import trainer as trainer_mod

    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke"  # emptied by main() before phase 6
    split_dir = work / "splits" / "tiny_kitti"
    split_dir.mkdir(parents=True, exist_ok=True)
    items = [f"2011_09_26/2011_09_26_drive_0001_sync {i} {side}" for i in (0, 1) for side in ("l", "r")]
    for which in ("train", "val"):
        (split_dir / f"{which}_files.txt").write_text("".join(line + "\n" for line in items))
    os.environ["DYNAMO_SPLITS_DIR"] = str(work / "splits")
    log_dir = work / "logs"
    argv = [
        "-d", "kitti", "-n", name, "--data_path", str(root / "assets" / "tiny_kitti") + "/",
        "--split", "tiny_kitti", "--depth_model", depth_model, "--height", str(H), "--width", str(W),
        "--batch_size", str(B), "--weights_init", "scratch",
        "--epoch_schedules", "1", "1", "1", "1", "--epoch-size", str(steps), "--log_frequency", "1",
        "--no_train_vis", "--log_dir", str(log_dir),
        "--print_opt", "",  # a bool flag of the reference's: the empty string is False
    ]
    print(f"curriculum: python -m dynamo_depth_torch.train {' '.join(argv)}")
    print(f"  native data plane: {'built' if native.available() else 'not built: ' + str(native.build_error).splitlines()[-1]}")

    # Per phase: each step's launches, time and losses (the wrapper adds
    # nothing to the step but the synchronisations around it), and the
    # weights before and after.
    records = {p: [] for p in trainer_mod.PHASES}
    weights = {}
    run_step, run_phase = trainer_mod.Trainer.train_step, trainer_mod.Trainer.run_phase

    def recorded_step(self, batch, generator, step):
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        losses = run_step(self, batch, generator, step)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        records[self.phase].append({"ms": ms, "launches": {k: after[k] - before[k] for k in after},
                                  "losses": {k: float(v) for k, v in losses.items()},
                                  "wrapper": type(self.ddp).__name__})
        return losses

    def recorded_phase(self, phase, num_epoch):
        before = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        run_phase(self, phase, num_epoch)
        weights[phase] = (before, {n: p.detach().clone() for n, p in self.model.named_parameters()})

    trainer_mod.Trainer.train_step, trainer_mod.Trainer.run_phase = recorded_step, recorded_phase
    try:
        data_base.reset_decode_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer = train_entry.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        decodes = data_base.decode_counts()
    finally:
        trainer_mod.Trainer.train_step, trainer_mod.Trainer.run_phase = run_step, run_phase

    decoder = " and ".join(f"{k} ({n} frames)" for k, n in decodes.items() if n) or "none"
    print(f"  images decoded by: {decoder}")
    if not any(decodes.values()):
        raise SystemExit("the curriculum decoded no image")
    zero = [k for k, n in launches.items() if n == 0]
    if zero:
        raise SystemExit(f"kernels never launched in the curriculum: {zero}")
    per_step = {k: {} for k in launches}
    summary = {"wall_s": wall_s, "peak_bytes": peak, "decoder": decodes, "phases": {}}
    for phase, recs in records.items():
        if len(recs) != steps:
            raise SystemExit(f"{phase}: {len(recs)} steps, expected {steps}")
        expected = launches_per_step(trainer.cfg, phase)
        for i, rec in enumerate(recs):
            if rec["launches"] != expected:
                raise SystemExit(f"{phase} step {i}: launches {rec['launches']}, expected {expected}")
            bad = [k for k, v in rec["losses"].items() if not math.isfinite(v)]
            if bad:
                raise SystemExit(f"{phase} step {i}: non-finite losses {bad}")
        for k in launches:
            per_step[k][phase] = recs[0]["launches"][k]
        before, after = weights[phase]
        trainable = modules_for_networks(trainer_mod.PHASE_SPEC[phase][2])
        for module in MODULE_NAMES:
            names = [n for n in before if n.startswith(module + ".")]
            moved = [n for n in names if not torch.equal(before[n], after[n])]
            if module in trainable and not moved:
                raise SystemExit(f"{phase}: trainable module {module} did not move")
            if module not in trainable and moved:
                raise SystemExit(f"{phase}: frozen module {module} changed: {moved[:3]}")
        timing = [h for h in trainer.history if h["mode"] == "time" and h["phase"] == phase]
        data_s = sum(h["data_s"] for h in timing)
        compute_s = sum(h["compute_s"] for h in timing)
        ms = float(np.median([r["ms"] for r in recs]))
        summary["phases"][phase] = {"ms_per_step": ms, "step_ms": [r["ms"] for r in recs], "data_wait_s": data_s,
                                    "compute_s": compute_s, "loss": recs[-1]["losses"]["loss"]}
        each = ", ".join(f"{r['ms']:.1f}" for r in recs)
        print(f"  {phase}: {ms:.2f} ms/step (median of {steps}: {each}), "
              f"data wait {data_s * 1e3:.1f} ms and compute {compute_s * 1e3:.1f} ms over the logged steps "
              f"(log_time), launches per step {recs[0]['launches']}, trainable {'/'.join(trainable)} moved, "
              f"the others bit-identical, loss {recs[-1]['losses']['loss']:.5f} on {smi}")
    print(f"  curriculum: {wall_s:.1f} s wall for 4 phases x {steps} steps with a validation batch after each, "
          f"peak memory {peak / 2**30:.2f} GiB on {smi}")

    models = log_dir / name / "models"
    expected_files = {f"{m}.pth" for m in MODULE_NAMES} | {"adam.pth", "opt.json"}
    for phase in trainer_mod.PHASES:
        folder = models / f"{phase}_00"
        files = {f.name for f in folder.iterdir()} if folder.is_dir() else set()
        if files != expected_files:
            raise SystemExit(f"{folder}: {sorted(files)}, expected {sorted(expected_files)}")
    print(f"  checkpoints: {', '.join(f'{p}_00' for p in trainer_mod.PHASES)}, each with "
          f"{len(MODULE_NAMES)} module files, adam.pth and opt.json")
    wrappers = sorted({r["wrapper"] for recs in records.values() for r in recs})
    last = models / "fine_tune_00"
    if not reload:
        return {"launches": launches, "per_step": per_step, "summary": summary, "folder": str(last),
                "wrappers": wrappers}

    cfg = DynamoConfig.from_dict(json.loads((last / "opt.json").read_text()))
    cfg.load_ckpt = str(last)
    fresh = trainer_mod.Trainer(cfg)
    mine, loaded = trainer.model.state_dict(), fresh.model.state_dict()
    differ = [k for k in mine if not torch.equal(mine[k], loaded[k])]
    if mine.keys() != loaded.keys() or differ:
        raise SystemExit(f"fine_tune_00 loaded into a fresh trainer differs: {differ[:5]}")
    print(f"  fine_tune_00 loaded into a fresh Trainer: all {len(mine)} state-dict entries equal")
    del fresh

    resumed = train_entry.main(argv[:argv.index("--epoch_schedules")] + [
        "--epoch_schedules", "0", "0", "0", "1", "--epoch-size", "1", "--log_frequency", "1", "--no_train_vis",
        "--log_dir", str(work / f"resumed_{name}"), "--print_opt", "", "--load_ckpt", str(last), "--resume_optim",
    ])
    losses = [h["scalars"]["loss"] for h in resumed.history if h["mode"] == "train"]
    if resumed.opt_steps != steps + 1 or len(losses) != 1 or not math.isfinite(losses[0]):
        raise SystemExit(f"resumed fine_tune: {resumed.opt_steps} optimizer steps (expected {steps} restored + 1), "
                         f"train losses {losses}")
    print(f"  one more fine_tune step from fine_tune_00 with --resume_optim: Adam's count {steps} -> {steps + 1}, "
          f"loss {losses[0]:.5f}")
    summary["resumed_loss"] = losses[0]
    return {"launches": launches, "per_step": per_step, "summary": summary, "folder": last, "work": work,
            "wrappers": wrappers}


ODOM_SEG, ODOM_FRAMES = "val/segment-0000000001_eight_frames", 8
_FLOAT = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


def agree(what, err, tol):
    print(f"  {what}: card vs CPU {err:.3e} (tolerance {tol:.0e}) {'ok' if err <= tol else 'FAILED'}")
    if not err <= tol:
        raise SystemExit(f"{what}: the card's record disagrees with the CPU's")


def _table(path):
    text = Path(path).read_text().splitlines()
    rows = {line.split()[0]: [float(x) for x in _FLOAT.findall(line)]
            for line in text if line.split() and line.split()[0] in ("OVERALL", "BG", "STATIC", "MOT")}
    return rows, [line for line in text if not line.split() or line.split()[0] not in rows]


def compare_depth_tables(key, card_path, cpu_path):
    """The depth tables of the card's and the CPU's run: the same lines, and
    every metric to the printed 0.001."""
    (rows_c, text_c), (rows_p, text_p) = _table(card_path), _table(cpu_path)
    if text_c != text_p or rows_c.keys() != rows_p.keys() or not all(np.isfinite(v).all() for v in rows_c.values()):
        raise SystemExit(f"{key}: the tables differ: {rows_c} vs {rows_p}")
    agree(f"{key} table ({', '.join(rows_c)}; OVERALL abs_rel {rows_c['OVERALL'][0]:.3f})",
          max(float(np.abs(np.subtract(rows_c[r], rows_p[r])).max()) for r in rows_c), 1e-3 + 1e-9)


def build_odometry_segment(data_root):
    """An 8-frame Waymo segment: the vendored fixture's 3 images cycled, its
    intrinsics, and 8 ground-truth poses from a seeded random drive (the
    fixture's own 3 frames leave one non-edge frame and no 5-frame track)."""
    src = Path(__file__).resolve().parent / "assets" / "tiny_waymo" / "val" / "segment-0000000000_tiny_fixture" / "FRONT" / "rgb"
    dst = data_root / ODOM_SEG / "FRONT"
    (dst / "rgb" / "downsample").mkdir(parents=True)
    for i in range(ODOM_FRAMES):
        shutil.copy(src / "downsample" / f"{i % 3:06}.jpg", dst / "rgb" / "downsample" / f"{i:06}.jpg")
    shutil.copy(src / "cam.json", dst / "rgb" / "cam.json")
    rng = np.random.RandomState(8)
    pose, poses = np.eye(4), []
    for _ in range(ODOM_FRAMES):
        step = np.eye(4)
        a = rng.uniform(-0.02, 0.02)
        step[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        step[:3, 3] = [rng.uniform(-0.1, 0.1), rng.uniform(-0.05, 0.05), rng.uniform(0.5, 1.5)]
        pose = pose @ step
        poses.append(pose.reshape(-1))
    np.savetxt(dst / "odometry.txt", np.array(poses))


def run_eval(smi, folder, work):
    """Phase 8. Every eval CLI and the quick demo from ``folder`` on the card,
    then on the CPU, with the card's records held against the CPU's. Returns
    a summary; raises SystemExit on any failure."""
    import torch

    from dynamo_depth_torch import quick_demo
    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.eval import depth, motion_segmentation, odometry, visualize
    from dynamo_depth_torch.ops.kernels import launch_counts, reset_launch_counts
    from dynamo_depth_torch.training.synthetic import synthetic_batch
    from dynamo_depth_torch.training.trainer import Trainer

    root = Path(__file__).resolve().parent
    assets = root / "assets"
    kitti_seq, waymo_seg, nusc_scene = ("2011_09_26/2011_09_26_drive_0001_sync",
                                        "val/segment-0000000000_tiny_fixture", "scenes/scene-0001")
    splits = {
        "tiny_kitti": {"test": [f"{kitti_seq} {i} {s}" for i in range(3) for s in "lr"]},
        "tiny_waymo": {"test": [f"{waymo_seg} {i}" for i in range(3)], "test_mask": [f"{waymo_seg} {i}" for i in range(3)]},
        "odom": {"test": [f"{ODOM_SEG} {i}" for i in range(ODOM_FRAMES)]},
    }
    for name, files in splits.items():
        (work / "splits" / name).mkdir(parents=True, exist_ok=True)
        for which, lines in files.items():
            (work / "splits" / name / f"{which}_files.txt").write_text("".join(line + "\n" for line in lines))
    build_odometry_segment(work / "data")

    def argv(dataset, data, split, eval_dir):
        return ["-d", dataset, "--data_path", f"{data}/", "--split", split, "-l", str(folder), "--height", str(H),
                "--width", str(W), "-b", str(B), "--num_workers", "2", "--eval_dir", str(eval_dir)]

    def run_all(device):
        out_dir = work / "eval" / device
        t0 = time.perf_counter()
        rec = {
            "depth_kitti": depth.main(argv("kitti", assets / "tiny_kitti", "tiny_kitti", out_dir), device=device),
            "depth_waymo": depth.main(argv("waymo", assets / "tiny_waymo", "tiny_waymo", out_dir), device=device),
            "mot_seg": motion_segmentation.main(argv("waymo", assets / "tiny_waymo", "tiny_waymo", out_dir), device=device),
            "odometry": odometry.main(argv("waymo", work / "data", "odom", out_dir), device=device),
            "visualize": visualize.main(argv("waymo", assets / "tiny_waymo", "tiny_waymo", out_dir), device=device),
            "demo": quick_demo.main(["-l", str(folder), "--data_path", f"{assets / 'tiny_nuscenes'}/", "--height", str(H),
                                     "--width", str(W), "--out", str(out_dir / "demo")],
                                    device=device, filenames=[f"{nusc_scene} 1"]),
        }
        rec["seconds"] = time.perf_counter() - t0
        return rec

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    card = run_all("cuda")
    torch.cuda.synchronize()
    launches, peak = launch_counts(), torch.cuda.max_memory_allocated()
    cpu = run_all("cpu")
    print(f"  eval path on the card: {card['seconds']:.1f} s, on the CPU: {cpu['seconds']:.1f} s; "
          f"kernel launches on the card {launches}; peak memory {peak / 2**30:.2f} GiB on {smi}")
    if any(launches.values()):
        raise SystemExit(f"the eval path launched kernels of the training path: {launches}")

    for key in ("depth_kitti", "depth_waymo"):
        compare_depth_tables(key, card[key]["path"], cpu[key]["path"])

    mc, mp = card["mot_seg"], cpu["mot_seg"]
    zc, zp = np.load(mc["npz"]), np.load(mp["npz"])
    if not np.array_equal(zc["thrds"], zp["thrds"]) or mc["fp_tally"].keys() != mp["fp_tally"].keys():
        raise SystemExit(f"mot_seg: thresholds or FP tally categories differ: {mc['fp_tally']} vs {mp['fp_tally']}")
    pixels = 1280 * 1920  # the one non-edge frame at Waymo's full resolution
    agree("mot_seg tp/fp/fn (fraction of the pixels)",
          max(float(np.abs(mc[k] - mp[k]).max()) for k in ("tp", "fp", "fn")) / pixels, 1e-3)
    agree("mot_seg precision/recall/f1", max(float(np.abs(zc[k] - zp[k]).max()) for k in ("precision", "recall", "f1")),
          1e-3)
    # The tally counts the same false-positive pixels as fp, and a mask value
    # near the threshold moves across it with round-off just as there.
    agree(f"mot_seg FP tally {({str(k): int(v) for k, v in mc['fp_tally'].items()})} (fraction of the pixels)",
          max(abs(int(mc["fp_tally"][k]) - int(mp["fp_tally"][k])) for k in mc["fp_tally"]) / pixels, 1e-3)

    oc, op = np.load(card["odometry"]["npy"]), np.load(cpu["odometry"]["npy"])
    if oc.shape != op.shape or oc.shape[0] == 0:
        raise SystemExit(f"odometry: records of shape {oc.shape} and {op.shape}")
    agree(f"odometry ATE and speed ({oc.shape[0]} tracks; relative)",
          float((np.abs(oc - op) / np.abs(op)).max()), 1e-4)

    def frames_agree(what, fc, fp):
        if len(fc) != len(fp) or any(a.dtype != np.uint8 or a.shape != b.shape for a, b in zip(fc, fp)):
            raise SystemExit(f"{what}: frames differ in number, type or shape")
        diff = np.concatenate([np.abs(a.astype(int) - b.astype(int)).ravel() for a, b in zip(fc, fp)])
        agree(f"{what} frames ({len(fc)} of {fc[0].shape}; share more than one level apart)",
              float((diff > 1).mean()), 1e-3)

    for seg, (frames, written) in card["visualize"].items():
        frames_agree(f"visualize {seg}", frames, cpu["visualize"][seg][0])
        print(f"  visualize wrote {written}")
    frames_agree("quick demo", card["demo"], cpu["demo"])
    print(f"  plot files written: {mc['pdfs'] or 'none'}")
    for path in mc["missing"]:
        print(f"  plot file not written (no matplotlib): {path}")

    # predict alone: device ms per batch at the main path's size
    cfg = DynamoConfig.from_dict(json.loads((folder / "opt.json").read_text()))
    cfg.load_ckpt = str(folder)
    trainer = Trainer(cfg)
    batch = synthetic_batch(cfg, B, H, W)
    from torch.profiler import ProfilerActivity, profile

    from dynamo_depth_torch.bench.timing import self_device_us

    predict_ms = {}
    for flags in ((False, False), (True, False), (True, True)):
        dev_ms, wall_ms = [], []
        for i in range(2 + 5):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                trainer.predict(batch, *flags)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            if i >= 2:
                dev_ms.append(sum(self_device_us(e) for e in prof.key_averages()) / 1e3)
                wall_ms.append(wall)
        key = f"CmpFlow={flags[0]},MotMask={flags[1]}"
        predict_ms[key] = {"device_ms": float(np.median(dev_ms)), "wall_ms": float(np.median(wall_ms))}
        print(f"  predict {key} at {H}x{W} batch {B}: {predict_ms[key]['device_ms']:.3f} ms device, "
              f"{predict_ms[key]['wall_ms']:.3f} ms wall with the copy in (median of 5 after 2 warm-ups) on {smi}")
    return {"launches": launches, "peak_bytes": peak, "card_s": card["seconds"], "cpu_s": cpu["seconds"],
            "tables": {"kitti": card["depth_kitti"]["path"], "waymo": card["depth_waymo"]["path"]},
            "predict": predict_ms, "plots_written": mc["pdfs"], "plots_missing": mc["missing"],
            "odometry_ate": card["odometry"]["ates"]}


def card_vs_cpu_step(small):
    """Phases 5 and 9: one fine_tune step of ``small`` on the card (kernels)
    against the same step on the CPU (plain versions) from the same weights;
    raises SystemExit when a loss term disagrees."""
    import torch

    from dynamo_depth_torch.ops import ground_plane
    from dynamo_depth_torch.training.synthetic import synthetic_batch
    from dynamo_depth_torch.training.trainer import Trainer

    torch.manual_seed(0)
    t_gpu = Trainer(small, device="cuda", drop_path_rate=0.0)
    t_cpu = Trainer(small, device="cpu", drop_path_rate=0.0)
    t_cpu.model.load_state_dict({k: v.cpu() for k, v in t_gpu.model.state_dict().items()})
    batch_small = synthetic_batch(small, small.batch_size, small.height, small.width)
    draw = ground_plane.draw_sample_idx
    results = {}
    for label, tr in (("cuda", t_gpu), ("cpu", t_cpu)):
        idx_gen = torch.Generator().manual_seed(1)
        ground_plane.draw_sample_idx = lambda b, t, n, g, device: torch.randint(0, n, (b, t), generator=idx_gen).to(device)
        try:
            losses = tr.train_step(tr.to_device(batch_small), torch.Generator(device=tr.device).manual_seed(0), 5)
        finally:
            ground_plane.draw_sample_idx = draw
        results[label] = {k: float(v) for k, v in losses.items()}
    rel = {k: abs(results["cuda"][k] - results["cpu"][k]) / max(abs(results["cpu"][k]), 1e-6) for k in results["cpu"]}
    # cuDNN and the CPU convolutions sum in other orders: 1e-4 relative.
    # d_ground alone gets 5e-2: RANSAC keeps the hypothesis with the most
    # points within 0.005 of its plane, and round-off in the depth moves
    # points across that line, which can change the plane it keeps.
    tol = {k: 5e-2 if k == "loss_term/d_ground" else 1e-4 for k in rel}
    worst = max(rel, key=lambda k: rel[k] / tol[k])
    print(f"fine_tune step {small.depth_model} at {small.height}x{small.width}, card (kernels) vs CPU (plain): "
          f"worst relative loss difference {rel[worst]:.2e} in {worst} (tolerance {tol[worst]:.0e}); "
          f"d_ground {rel['loss_term/d_ground']:.2e}")
    if rel[worst] > tol[worst]:
        raise SystemExit(f"card step disagrees with the CPU step: {results}")


def timed_steps(trainer, batch, gen, smi, label):
    """STEPS_WARMUP + STEPS_TIMED training steps with the launch counts set
    to 0 just before and read just after: finite losses, moved weights and
    the launches per step that ``trainer.cfg.scales`` asks for. Returns
    {"ms": median of the timed steps, "step_ms", "launches", "steps",
    "peak_bytes", "losses"}."""
    import torch

    from dynamo_depth_torch.ops.kernels import launch_counts, reset_launch_counts

    watch = {n: p.detach().clone() for n, p in list(trainer.model.named_parameters())[::40]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_ms = []
    for step in range(STEPS_WARMUP + STEPS_TIMED):
        t0 = time.perf_counter()
        losses = trainer.train_step(batch, gen, step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        bad = [k for k, v in losses.items() if not math.isfinite(float(v))]
        if bad:
            raise SystemExit(f"{label} step {step}: non-finite losses {bad}")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = STEPS_WARMUP + STEPS_TIMED
    per_step = launches_per_step(trainer.cfg)
    for k, n in counts.items():
        if n != per_step[k] * steps:
            raise SystemExit(f"{label}: {k} launched {n} times in {steps} steps, expected {per_step[k] * steps}")
    # Every watched weight whose gradient can move it has moved. The dilated
    # blocks' unused LayerNorm receives no gradient; and Adam moves a weight
    # by about lr * g / (|g| + 1e-8), which for |g| far below its eps 1e-8
    # (~1e-15 on LiteMono's stage-2 XCA qkv bias under bfloat16, found on
    # the card) falls under the weight's float32 spacing in most steps.
    trained = [(n, p) for n, p in trainer.model.named_parameters()
               if n in watch and p.grad is not None and float(p.grad.abs().max()) > 1e-8]
    frozen = [n for n, p in trained if torch.equal(p.detach(), watch[n])]
    if not trained or frozen:
        raise SystemExit(f"{label}: weights that did not move: {frozen} of {len(trained)} watched")
    ms = float(np.median(step_ms[STEPS_WARMUP:]))
    cfg = trainer.cfg
    print(f"fine_tune {label} {cfg.height}x{cfg.width} batch {cfg.batch_size} on {smi}: "
          f"{ms:.2f} ms/step (median of {STEPS_TIMED}; warm-up {step_ms[0]:.1f}, {step_ms[1]:.1f} ms), "
          f"{cfg.batch_size / ms * 1e3:.2f} examples/s, peak memory {peak / 2**30:.2f} GiB; "
          f"loss {float(losses['loss']):.6f}; launches {counts}")
    return {"ms": ms, "step_ms": step_ms, "launches": counts, "steps": steps, "peak_bytes": peak,
            "losses": {k: float(v) for k, v in losses.items()}}


def profiled_step(trainer, batch, gen, step, step_ms, top=8):
    """One more training step under the profiler: device busy ms, device ops,
    the ``top`` largest device entries, and each kernel's device ms per launch
    inside the step. Returns {"busy_ms", "wall_ms", "ops", "in_step_ms",
    "launches"}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dynamo_depth_torch.bench.timing import self_device_us

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch, gen, step)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, copies, sets): operator-level events
    # carry the device time of the kernels they launched, and annotations
    # (the optimizer's step) span them.
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    busy_ms = sum(self_device_us(e) for e in events) / 1e3
    events.sort(key=self_device_us, reverse=True)
    ops = sum(e.count for e in events)
    print(f"profiled step: wall {wall_ms:.1f} ms (profiler on), device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.0f}% of wall; {100 * busy_ms / step_ms:.0f}% of the unprofiled step), "
          f"{ops} device ops; top by device time:")
    for e in events[:top]:
        print(f"  {self_device_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:100]}")
    ours = sum(self_device_us(e) for e in events if any(n in e.key for n in ("warp_", "photometric_")))
    print(f"  the four port kernels: {ours / 1e3:.3f} ms ({100 * ours / 1e3 / max(busy_ms, 1e-9):.2f}% of device time)")
    per_step = launches_per_step(trainer.cfg)
    in_step, launches = {}, {}
    for k in per_step:
        mine = [e for e in events if f"{k}_kernel" in e.key]
        launches[k] = sum(e.count for e in mine)
        if launches[k] != per_step[k]:
            raise SystemExit(f"{k}: {launches[k]} launches in the profiled step, expected {per_step[k]}")
        in_step[k] = sum(self_device_us(e) for e in mine) / 1e3 / launches[k]
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "ops": ops, "in_step_ms": in_step, "launches": launches}


def run_monodepthv2(smi, work):
    """Phase 9: the monodepthv2 network (ResNet-18 depth encoder, Monodepth2
    decoder, 4 scales): the fine_tune step on the card against the CPU at
    64x96, the step at 192x640 batch 3 (8 launches of each kernel), the
    curriculum from the entry point on tiny_kitti, and eval.depth on its
    fine_tune_00 on the card against the CPU."""
    import torch

    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.eval import depth
    from dynamo_depth_torch.training.synthetic import synthetic_batch
    from dynamo_depth_torch.training.trainer import Trainer

    card_vs_cpu_step(DynamoConfig(dataset="kitti", depth_model="monodepthv2", height=64, width=96, batch_size=2,
                                  weights_init="scratch"))
    cfg = DynamoConfig(dataset="kitti", depth_model="monodepthv2", height=H, width=W, batch_size=B,
                       weights_init="scratch")
    trainer = Trainer(cfg)
    batch = trainer.to_device(synthetic_batch(cfg, B, cfg.height, cfg.width))
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    step = timed_steps(trainer, batch, gen, smi, "monodepthv2 float32")
    profiled = profiled_step(trainer, batch, gen, step["steps"], step["ms"])
    print("  in-step ms per launch: " + ", ".join(f"{k} {v:.4f}" for k, v in profiled["in_step_ms"].items()))
    del trainer, batch

    print("monodepthv2 curriculum from the entry point:")
    curriculum = run_curriculum(smi, depth_model="monodepthv2", steps=2, name="curriculum_monodepthv2")
    seq = "2011_09_26/2011_09_26_drive_0001_sync"
    (work / "splits" / "tiny_kitti" / "test_files.txt").write_text(
        "".join(f"{seq} {i} {side}\n" for i in range(3) for side in "lr"))
    args = ["-d", "kitti", "--data_path", str(Path(__file__).resolve().parent / "assets" / "tiny_kitti") + "/",
            "--split", "tiny_kitti", "-l", str(curriculum["folder"]), "--height", str(H), "--width", str(W),
            "-b", str(B), "--num_workers", "2", "--depth_model", "monodepthv2"]
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        card = depth.main(args + ["--eval_dir", str(work / "eval_monodepthv2" / "cuda")], device="cuda")
    depth_s = time.perf_counter() - t0
    print(log.getvalue(), end="")
    if "FAILED" in log.getvalue():
        raise SystemExit("eval.depth did not load every module of the monodepthv2 folder")
    cpu = depth.main(args + ["--eval_dir", str(work / "eval_monodepthv2" / "cpu")], device="cpu")
    print(f"  eval.depth of the monodepthv2 fine_tune_00: {depth_s:.1f} s on the card")
    compare_depth_tables("monodepthv2 depth_kitti", card["path"], cpu["path"])
    return {"step": step, "profiled": profiled, "curriculum": curriculum, "depth_eval_s": depth_s}


# Relative difference allowed between a loss term of the bfloat16 step and
# the float32 step from the same weights, batch and draws, for the terms
# RANSAC does not enter (found on the card: 7e-6 to 6.2e-4). d_ground and
# the totals that hold it follow RANSAC's inlier count, which bfloat16's
# rounding of the near-constant disparity of random weights changes (found:
# 0.55 on the card; up to 2.7x at 64x96 on the CPU, in the JAX package's
# bfloat16 step as in the port's): they must be finite, and are recorded.
BF16_LOSS_TOL = 1e-2
RANSAC_TERMS = {"loss", "loss_term/d_ground"} | {f"loss_term/{s}" for s in range(4)}


def run_bf16(smi, f32_step, f32_profiled):
    """Phase 10: the LiteMono fine_tune step with compute_dtype="bfloat16"
    from phase 6's seed-0 weights: its loss terms against a float32 step
    from the same weights, batch and draws; ms/step, device busy ms, peak
    memory and in-step kernel times beside phase 6's; one bfloat16
    monodepthv2 step."""
    import torch

    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.training.synthetic import synthetic_batch
    from dynamo_depth_torch.training.trainer import Trainer

    kw = dict(dataset="kitti", depth_model="litemono", height=H, width=W, batch_size=B, weights_init="scratch")
    t32 = Trainer(DynamoConfig(**kw))
    t16 = Trainer(DynamoConfig(**kw, compute_dtype="bfloat16"))
    sd32, sd16 = t32.model.state_dict(), t16.model.state_dict()
    if any(not torch.equal(sd32[k], sd16[k]) for k in sd32):
        raise SystemExit("the bfloat16 and float32 trainers start from different weights")
    batch = t16.to_device(synthetic_batch(t16.cfg, B, H, W))
    losses = {}
    for label, tr in (("float32", t32), ("bfloat16", t16)):
        out = tr.train_step(batch, torch.Generator(device="cuda").manual_seed(0), 0)
        losses[label] = {k: float(v) for k, v in out.items()}
    del t32
    bad = [k for k, v in losses["bfloat16"].items() if not math.isfinite(v)]
    if bad:
        raise SystemExit(f"bfloat16 step: non-finite losses {bad}")
    rel = {k: abs(losses["bfloat16"][k] - losses["float32"][k]) / max(abs(losses["float32"][k]), 1e-6)
           for k in losses["float32"] if not k.startswith("loss_coef/")}
    worst = max((k for k in rel if k not in RANSAC_TERMS), key=rel.get)
    print(f"fine_tune LiteMono bfloat16 vs float32 at {H}x{W} batch {B}, same weights and draws: worst relative "
          f"loss difference {rel[worst]:.2e} in {worst} (tolerance {BF16_LOSS_TOL:.0e}; recorded only, through "
          f"RANSAC: " + ", ".join(f"{k.split('/')[-1]} {rel[k]:.2e}" for k in rel if k in RANSAC_TERMS) + "); "
          + ", ".join(f"{k.split('/')[-1]} {v:.2e}" for k, v in rel.items() if k not in RANSAC_TERMS))

    gen = torch.Generator(device="cuda").manual_seed(0)
    step = timed_steps(t16, batch, gen, smi, "LiteMono bfloat16")
    profiled = profiled_step(t16, batch, gen, step["steps"], step["ms"])
    print(f"  bfloat16 against float32 (phase 6): {step['ms']:.2f} vs {f32_step['ms']:.2f} ms/step, device busy "
          f"{profiled['busy_ms']:.1f} vs {f32_profiled['busy_ms']:.1f} ms, peak {step['peak_bytes'] / 2**30:.2f} vs "
          f"{f32_step['peak_bytes'] / 2**30:.2f} GiB; in-step ms per launch: "
          + ", ".join(f"{k} {v:.4f} vs {f32_profiled['in_step_ms'][k]:.4f}" for k, v in profiled["in_step_ms"].items()))
    del t16, batch

    md2 = Trainer(DynamoConfig(**dict(kw, depth_model="monodepthv2", compute_dtype="bfloat16")))
    out = md2.train_step(md2.to_device(synthetic_batch(md2.cfg, B, H, W)), torch.Generator(device="cuda").manual_seed(0), 0)
    bad = [k for k, v in out.items() if not math.isfinite(float(v))]
    if bad:
        raise SystemExit(f"bfloat16 monodepthv2 step: non-finite losses {bad}")
    print(f"  one bfloat16 monodepthv2 step: loss {float(out['loss']):.6f}, every term finite")
    if rel[worst] > BF16_LOSS_TOL:
        raise SystemExit(f"bfloat16 step disagrees with the float32 step: {losses}")
    return {"step": step, "profiled": profiled, "rel": rel, "md2_loss": float(out["loss"])}


DDP_TIMEOUT_S = 600  # a phase-11 launch past it is killed: a hung collective fails the script


def launch(nproc, worker, out):
    """``python -m torch.distributed.run --nproc_per_node nproc chip_smoke.py
    --ddp-worker worker out``, its output shown; raises SystemExit when it
    fails or outlasts DDP_TIMEOUT_S (then it and its ranks are killed).
    Returns the wall seconds."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc), "--master_addr",
           "127.0.0.1", "--master_port", str(free_port()), str(Path(__file__).resolve()), "--ddp-worker", worker,
           str(out)]
    print(f"  launch: {' '.join(cmd[1:])}", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(Path(__file__).resolve().parent), start_new_session=True)
    try:
        rc = proc.wait(timeout=DDP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise SystemExit(f"{worker}: still running after {DDP_TIMEOUT_S} s, killed")
    if rc != 0:
        raise SystemExit(f"{worker}: the launch failed with exit code {rc}")
    return time.perf_counter() - t0


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ddp_worker(worker, out):
    """One rank of a phase-11 launch (torchrun's environment is set)."""
    import torch

    from dynamo_depth_torch.parallel import dist as pdist

    out = Path(out)
    rank = int(os.environ["RANK"])
    if worker == "nccl1":
        # 11a: the curriculum from the entry point, which joins the NCCL group.
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
        result = run_curriculum(smi, steps=2, name="ddp_world1", reload=False)
        result["backend"] = torch.distributed.get_backend()
        result["world"] = pdist.world_size()
        (out / "nccl1.json").write_text(json.dumps(result))
        torch.distributed.destroy_process_group()
        return 0
    if worker == "gloo2":
        torch.set_num_threads(4)
        pdist.init_distributed(device="cuda:0", backend="gloo")  # NCCL refuses two ranks on one card
        result = {"main_path": gloo_main_path(rank), "card_vs_cpu": gloo_card_vs_cpu(rank),
                  "eval": gloo_eval(rank, out)}
        (out / f"gloo2_rank{rank}.json").write_text(json.dumps(result))
        torch.distributed.destroy_process_group()
        return 0
    raise SystemExit(f"unknown worker {worker}")


def gloo_main_path(rank, steps=3):
    """11b: ``steps`` fine_tune steps at 192x640, batch 3 per rank, from
    seed-0 weights, both ranks on cuda:0 over gloo: each rank's launches per
    step, ms per step, and the ranks' parameters and BatchNorm buffers
    bit-identical after every step (``check_replicated`` raises if not)."""
    import torch

    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.ops.kernels import launch_counts, reset_launch_counts
    from dynamo_depth_torch.parallel import dist as pdist
    from dynamo_depth_torch.training.synthetic import synthetic_batch
    from dynamo_depth_torch.training.trainer import Trainer

    cfg = DynamoConfig(dataset="kitti", depth_model="litemono", height=H, width=W, batch_size=B, weights_init="scratch")
    trainer = Trainer(cfg, device="cuda:0", phase="fine_tune")
    world = pdist.world_size()
    rows = synthetic_batch(cfg, B * world, H, W)
    batch = trainer.to_device({k: v[rank * B:(rank + 1) * B] for k, v in rows.items()})
    expected = launches_per_step(cfg)
    step_ms, launches = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for step in range(steps):
        before = launch_counts()
        t0 = time.perf_counter()
        losses = trainer.train_step(batch, trainer.generator, step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
        if launches[-1] != expected:
            raise SystemExit(f"rank {rank} step {step}: launches {launches[-1]}, expected {expected}")
        bad = [k for k, v in losses.items() if not math.isfinite(float(v))]
        if bad:
            raise SystemExit(f"rank {rank} step {step}: non-finite losses {bad}")
        pdist.check_replicated(trainer.model)
    total = launch_counts()
    trainable = sum(p.numel() for p in trainer.model.parameters() if p.requires_grad)
    bn = sum(b.numel() for n, b in trainer.model.named_buffers() if n.endswith(("running_mean", "running_var")))
    return {"step_ms": step_ms, "launches_per_step": launches, "launches": total, "wrapper": type(trainer.ddp).__name__,
            "trainable_params": trainable, "bn_values": bn, "allreduce_bytes_per_step": 4 * (trainable + bn),
            "loss": float(losses["loss"]), "peak_bytes": torch.cuda.max_memory_allocated()}


def gloo_card_vs_cpu(rank):
    """11b at 64x96: one fine_tune step of the two ranks on the card
    (kernels) against one of the same two ranks on the CPU (plain versions),
    from the same weights, rows and RANSAC draws; the averaged loss terms
    that RANSAC does not enter at phase 5's tolerance."""
    import torch

    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.ops import ground_plane
    from dynamo_depth_torch.training.synthetic import synthetic_batch
    from dynamo_depth_torch.training.trainer import Trainer

    small = DynamoConfig(dataset="kitti", height=64, width=96, batch_size=2, weights_init="scratch")
    t_gpu = Trainer(small, device="cuda:0", drop_path_rate=0.0)
    t_cpu = Trainer(small, device="cpu", drop_path_rate=0.0)
    t_cpu.model.load_state_dict({k: v.cpu() for k, v in t_gpu.model.state_dict().items()})
    rows = synthetic_batch(small, 4, small.height, small.width)
    local = {k: v[rank * 2:(rank + 1) * 2] for k, v in rows.items()}
    draw = ground_plane.draw_sample_idx
    results = {}
    for label, tr in (("cuda", t_gpu), ("cpu", t_cpu)):
        idx_gen = torch.Generator().manual_seed(1 + rank)
        ground_plane.draw_sample_idx = lambda b, t, n, g, device: torch.randint(0, n, (b, t), generator=idx_gen).to(device)
        try:
            losses = tr.train_step(tr.to_device(local), torch.Generator(device=tr.device).manual_seed(0), 5)
        finally:
            ground_plane.draw_sample_idx = draw
        results[label] = {k: float(v) for k, v in losses.items()}
    rel = {k: abs(results["cuda"][k] - results["cpu"][k]) / max(abs(results["cpu"][k]), 1e-6) for k in results["cpu"]}
    # Phase 5's 1e-4 for every term RANSAC does not enter. RANSAC keeps the
    # hypothesis with the most inliers, and on these rows two hypotheses lie
    # so close that the CPU's own thread count moves d_ground by 3e-4: the
    # card may keep another plane, so d_ground and the totals that hold it
    # must be finite and are recorded (found: 0.15 in one run).
    worst = max((k for k in rel if k not in RANSAC_TERMS), key=rel.get)
    bad = [k for k in RANSAC_TERMS & rel.keys() if not math.isfinite(results["cuda"][k])]
    if rel[worst] > 1e-4 or bad:
        raise SystemExit(f"rank {rank}: the 2-rank card step disagrees with the 2-rank CPU step: {results}")
    return {"worst": worst, "rel": rel[worst], "tol": 1e-4, "ransac_rel": {k: rel[k] for k in RANSAC_TERMS & rel.keys()},
            "losses": results}


def gloo_eval(rank, out):
    """11c: eval.depth of phase 7's fine_tune_00 with the two ranks on the
    card, on tiny_kitti and tiny_waymo, as phase 8 ran it on one process."""
    from dynamo_depth_torch.eval import depth

    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke"
    folder = work / "logs" / "curriculum" / "models" / "fine_tune_00"
    paths = {}
    for dataset, split in (("kitti", "tiny_kitti"), ("waymo", "tiny_waymo")):
        argv = ["-d", dataset, "--data_path", f"{root / 'assets' / f'tiny_{dataset}'}/", "--split", split, "-l",
                str(folder), "--height", str(H), "--width", str(W), "-b", str(B), "--num_workers", "2",
                "--eval_dir", str(out / "eval")]
        paths[dataset] = depth.main(argv, device="cuda:0")["path"]
    return paths


def run_ddp(smi, phase7, phase8_tables):
    """Phase 11: the port's data parallelism on the one card. 11a: the
    curriculum from the entry point under torchrun at world size 1 over NCCL;
    11b: two gloo ranks sharing the card, bit-equal after every step and held
    to the same two ranks on the CPU; 11c: eval.depth with the two ranks
    against phase 8's one-process tables."""
    import torch

    out = Path(__file__).resolve().parent / "build" / "chip_smoke" / "ddp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    torch.cuda.empty_cache()

    print("11a: torchrun --nproc_per_node 1 of the entry point's curriculum (NCCL, world size 1):")
    wall_a = launch(1, "nccl1", out)
    a = json.loads((out / "nccl1.json").read_text())
    if a["backend"] != "nccl" or a["world"] != 1 or a["wrappers"] != ["DistributedDataParallel"]:
        raise SystemExit(f"11a did not train through DDP over NCCL: {a['backend']}, {a['world']}, {a['wrappers']}")
    for phase, rec in a["summary"]["phases"].items():
        one = phase7["summary"]["phases"][phase]
        print(f"  {phase}: steps of {', '.join(f'{v:.1f}' for v in rec['step_ms'])} ms at world size 1 through DDP "
              f"(a new process: its first step is cold); phase 7 in one process: "
              f"{', '.join(f'{v:.1f}' for v in one['step_ms'])} ms on {smi}")
    print(f"  11a: {wall_a:.1f} s of wall with the launch")

    print("11b and 11c: torchrun --nproc_per_node 2, both ranks on cuda:0 over gloo:")
    wall_b = launch(2, "gloo2", out)
    ranks = [json.loads((out / f"gloo2_rank{r}.json").read_text()) for r in (0, 1)]
    mp = [r["main_path"] for r in ranks]
    for r, m in enumerate(mp):
        if m["wrapper"] != "DistributedDataParallel":
            raise SystemExit(f"11b rank {r} did not train through DDP: {m['wrapper']}")
        print(f"  rank {r}: fine_tune {H}x{W} batch {B} per rank, ms/step {', '.join(f'{v:.1f}' for v in m['step_ms'])}"
              f" (two processes sharing one card over a host-staged gloo: no measure of scaling), launches per "
              f"step {m['launches_per_step'][0]}, loss {m['loss']:.6f}, peak {m['peak_bytes'] / 2**30:.2f} GiB")
    if mp[0]["loss"] != mp[1]["loss"]:
        raise SystemExit(f"11b: the ranks' averaged losses differ: {mp[0]['loss']} vs {mp[1]['loss']}")
    print(f"  parameters and BatchNorm buffers bit-identical on both ranks after each of {len(mp[0]['step_ms'])} "
          f"steps; all-reduced per step: {mp[0]['trainable_params']} trainable parameters and {mp[0]['bn_values']} "
          f"BatchNorm values, {mp[0]['allreduce_bytes_per_step'] / 2**20:.2f} MiB")
    cvc = ranks[0]["card_vs_cpu"]
    print(f"  64x96 fine_tune step, 2 ranks on the card (kernels) vs 2 ranks on the CPU (plain): worst relative loss "
          f"difference {cvc['rel']:.2e} in {cvc['worst']} (tolerance {cvc['tol']:.0e}; recorded only, through RANSAC: "
          + ", ".join(f"{k.split('/')[-1]} {v:.2e}" for k, v in sorted(cvc["ransac_rel"].items())) + ")")
    for dataset, path in ranks[0]["eval"].items():
        one, two = Path(phase8_tables[dataset]).read_text(), Path(path).read_text()
        if one != two:
            raise SystemExit(f"11c: the 2-rank eval.depth table of {dataset} differs from the 1-process one:\n{two}\n{one}")
        print(f"  11c eval.depth on tiny_{dataset}: the 2-rank table equals phase 8's one-process table")
    if not Path(ranks[0]["eval"]["kitti"]).exists() or ranks[1]["eval"]["kitti"] != ranks[0]["eval"]["kitti"]:
        raise SystemExit("11c: rank 0 wrote no table")
    print(f"  11b and 11c: {wall_b:.1f} s of wall with the launch")
    return {"nccl1": a, "gloo2": ranks, "wall_s": {"11a": wall_a, "11bc": wall_b}}


class RecordingWandb:
    """Phase 12a's stand-in for wandb in ``sys.modules``: ``init``, ``log``
    and ``Image`` record their arguments, so the real wandb (and its
    network) is never reached."""

    def __init__(self):
        self.inits, self.logs = [], []

    def init(self, **kwargs):
        self.inits.append(kwargs)

    def log(self, data, step=None):
        self.logs.append((data, step))

    def Image(self, array):  # noqa: N802 - wandb's name
        return np.array(array)


def grids_agree(what, card, cpu, h):
    """Phase 12a: the card's visualisation grids against the CPU's. The
    first two rows of each grid (images, reconstruction, L1, disparity,
    mask, depth) to VIS_TOL; the colour wheels of the third as phase 8 holds
    frames: 99.9% of the values within one level of 255 (the hue of a flow
    near zero, at the focus of expansion, turns with round-off)."""
    if card.shape != cpu.shape:
        raise SystemExit(f"{what}: grids of shape {card.shape} and {cpu.shape}")
    diff = np.abs(card - cpu)
    agree(f"{what}: rows 1-2 max abs", float(diff[:, :2 * h].max()), VIS_TOL)
    agree(f"{what}: colour wheels, share more than one level apart", float((diff[:, 2 * h:] > 1 / 255).mean()), 1e-3)


# Phase 12a's tolerance on the grids' first two rows, card against CPU:
# float32 networks whose convolutions sum in other orders (phase 5 holds the
# losses to 1e-4 relative), on values in [0, 1], the L1 and depth columns
# divided by their maxima.
VIS_TOL = 1e-3


def run_vis(smi, work):
    """12a: the entry point's curriculum with the training visualisation on,
    through a recording wandb; each log_vis call's launches and wall ms; then
    log_vis of one batch on the card and on the CPU from the same weights."""
    import torch

    from dynamo_depth_torch import train as train_entry
    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.data.loader import collate
    from dynamo_depth_torch.data.splits import read_split
    from dynamo_depth_torch.ops.kernels import launch_counts, reset_launch_counts
    from dynamo_depth_torch.training import trainer as trainer_mod

    root = Path(__file__).resolve().parent
    argv = ["-d", "kitti", "-n", "vis", "--data_path", str(root / "assets" / "tiny_kitti") + "/", "--split",
            "tiny_kitti", "--height", str(H), "--width", str(W), "--batch_size", str(B), "--weights_init", "scratch",
            "--epoch_schedules", "1", "1", "1", "1", "--epoch-size", "1", "--log_frequency", "1",
            "--log_dir", str(work / "logs"), "--print_opt", ""]
    print(f"12a: python -m dynamo_depth_torch.train {' '.join(argv)} (wandb: a recording stand-in)")
    calls, steps = [], []
    log_vis, train_step = trainer_mod.Trainer.log_vis, trainer_mod.Trainer.train_step

    def timed(fn, records):
        def wrapper(self, *args):
            torch.cuda.synchronize()
            before = launch_counts()
            t0 = time.perf_counter()
            out = fn(self, *args)
            torch.cuda.synchronize()
            after = launch_counts()
            records.append({"phase": self.phase, "ms": (time.perf_counter() - t0) * 1e3,
                            "launches": {k: after[k] - before[k] for k in after}})
            return out
        return wrapper

    stub = RecordingWandb()
    saved = sys.modules.get("wandb")
    sys.modules["wandb"] = stub
    trainer_mod.Trainer.log_vis, trainer_mod.Trainer.train_step = timed(log_vis, calls), timed(train_step, steps)
    try:
        reset_launch_counts()
        trainer = train_entry.main(argv)
        launches = launch_counts()
    finally:
        trainer_mod.Trainer.log_vis, trainer_mod.Trainer.train_step = log_vis, train_step
        if saved is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved
    cfg = trainer.cfg
    if stub.inits != [{"project": "Dynamo", "name": "vis", "notes": cfg.comment, "config": cfg.to_dict()}]:
        raise SystemExit(f"wandb.init was called with {stub.inits}")
    expected = {"warp_fwd": 2 * len(cfg.scales), "warp_bwd": 0, "photometric_fwd": 0, "photometric_bwd": 0}
    if [c["phase"] for c in calls] != list(trainer_mod.PHASES) or any(c["launches"] != expected for c in calls):
        raise SystemExit(f"log_vis calls {calls}, expected one per phase launching {expected}")
    vis = [(data, step) for data, step in stub.logs if any(k.startswith("vis/") for k in data)]
    scalars = [(data, step) for data, step in stub.logs if not any(k.startswith("vis/") for k in data)]
    for g_step, (data, step) in enumerate(vis):
        if step != g_step or sorted(data) != [f"vis/train_{j}" for j in range(B)]:
            raise SystemExit(f"step {g_step}: logged {sorted(data)} at step {step}")
        for key, grid in data.items():
            if grid.shape != (3 * H, 3 * W, 3) or not np.isfinite(grid).all() or grid.min() < 0 or grid.max() > 1:
                raise SystemExit(f"step {g_step} {key}: grid of shape {grid.shape}, range {grid.min()}..{grid.max()}")
    history = [h for h in trainer.history if h["mode"] in ("train", "val")]
    if len(vis) != len(trainer_mod.PHASES) or len(scalars) != len(history) or any(
            data != {f"{h['mode']}_{k}": v for k, v in h["scalars"].items()} or step != h["g_step"]
            for (data, step), h in zip(scalars, history)):
        raise SystemExit("the scalars logged to wandb are not {mode}_{key} of each train and val record")
    print(f"  4 phases x 1 step: wandb.init once (project Dynamo); per step {B} grids vis/train_j of "
          f"{3 * H}x{3 * W}x3, finite, in [0, 1]; train_ and val_ scalars as the JAX package names them "
          f"({', '.join(sorted(scalars[0][0])[:3])}, ...); launches per log_vis call {calls[0]['launches']}")
    for c, st in zip(calls, steps):
        print(f"  {c['phase']}: log_vis {c['ms']:.1f} ms wall (rendering and the host copies), the step "
              f"{st['ms']:.1f} ms, on {smi}")

    # log_vis of one batch on the card and on the CPU, from the same weights.
    cpu = trainer_mod.Trainer(DynamoConfig.from_dict(cfg.to_dict()), device="cpu", phase=trainer.phase)
    cpu.model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    ds = trainer.get_dataset(read_split(cfg.split, "train")[:B])
    batch = collate([ds.get_item(i) for i in range(B)])
    t0 = time.perf_counter()
    card_grids = trainer.vis_grids(trainer.to_device(batch))
    card_ms = (time.perf_counter() - t0) * 1e3
    cpu_grids = cpu.vis_grids(cpu.to_device(batch))
    grids_agree(f"log_vis grids of one tiny_kitti batch ({trainer.phase}), card vs CPU", card_grids, cpu_grids, H)
    del cpu
    return {"calls": calls, "steps": steps, "launches": launches, "vis_ms": [c["ms"] for c in calls],
            "step_ms": [s["ms"] for s in steps], "grid_ms_one_batch": card_ms,
            "launches_per_log_vis": calls[0]["launches"], "folder": work / "logs" / "vis" / "models" / "fine_tune_00"}


def run_jax_folder(smi, work, folder, phase8_table):
    """12b: phase 7's last folder written in the JAX package's layout
    (``.msgpack`` modules, ``meta.json``, optax's ``adam.msgpack``), then
    ``eval.depth`` and a resumed fine_tune step from it on the card, against
    the same from the ``.pth`` folder."""
    import torch

    from dynamo_depth_torch import train as train_entry
    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.eval import depth
    from dynamo_depth_torch.training import checkpoint as ckpt
    from dynamo_depth_torch.training.trainer import Trainer

    root = Path(__file__).resolve().parent
    cfg = DynamoConfig.from_dict(json.loads((folder / "opt.json").read_text()))
    cfg.load_ckpt = str(folder)
    source = Trainer(cfg)
    source.load_optimizer(str(folder))
    jax_folder = work / "logs" / "jax_layout" / "models" / "fine_tune_00"
    t0 = time.perf_counter()
    ckpt.save_jax_folder(source.model, str(jax_folder), height=H, width=W, optimizer=source.optimizer)
    write_s = time.perf_counter() - t0
    files = sorted(p.name for p in jax_folder.iterdir())
    size = sum(p.stat().st_size for p in jax_folder.iterdir())
    print(f"12b: {folder.name} with its Adam state (step {source.opt_steps}) written in the JAX package's layout in "
          f"{write_s:.1f} s: {', '.join(files)} ({size / 2**20:.1f} MiB)")
    if any(f.endswith(".pth") for f in files) or "adam.msgpack" not in files or "meta.json" not in files:
        raise SystemExit(f"the JAX folder holds {files}")
    del source

    args = ["-d", "kitti", "--data_path", str(root / "assets" / "tiny_kitti") + "/", "--split", "tiny_kitti",
            "--height", str(H), "--width", str(W), "-b", str(B), "--num_workers", "2"]
    tables, eval_s = {}, {}
    for label, path in (("msgpack", jax_folder), ("pth", folder)):
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            out = depth.main(args + ["-l", str(path), "--eval_dir", str(work / "eval_jax_folder" / label)],
                             device="cuda")
        eval_s[label] = time.perf_counter() - t0
        if "FAILED" in log.getvalue() or "PARTIAL" in log.getvalue():
            raise SystemExit(f"eval.depth did not load every module of {path}:\n{log.getvalue()}")
        tables[label] = [line for line in out["lines"] if "Model Path" not in line]
    reference = [line for line in Path(phase8_table).read_text().splitlines(keepends=True) if "Model Path" not in line]
    if tables["msgpack"] != tables["pth"] or "".join(tables["pth"]).split() != "".join(reference).split():
        raise SystemExit(f"eval.depth tables differ:\n{''.join(tables['msgpack'])}\n{''.join(tables['pth'])}")
    print(f"  eval.depth -l <JAX folder> on the card: its table equals the .pth folder's and phase 8's; "
          f"{eval_s['msgpack']:.2f} s from the .msgpack folder, {eval_s['pth']:.2f} s from the .pth one, on {smi}")

    # One fine_tune step resumed from each folder, and once more from the
    # .pth folder: the step's backward is not bitwise repeatable on the card
    # (atomic adds in the backward of bilinear upsampling and of reflection
    # padding), so the .pth folder's own repeat says what bitwise means here.
    resume = ["-d", "kitti", "-n", "resume", "--data_path", str(root / "assets" / "tiny_kitti") + "/", "--split",
              "tiny_kitti", "--height", str(H), "--width", str(W), "--batch_size", str(B), "--weights_init",
              "scratch", "--epoch_schedules", "0", "0", "0", "1", "--epoch-size", "1", "--log_frequency", "1",
              "--no_train_vis", "--print_opt", "", "--resume_optim"]
    runs = {}
    for label, path in (("msgpack", jax_folder), ("pth", folder), ("pth again", folder)):
        trainer = train_entry.main(resume + ["--load_ckpt", str(path), "--log_dir",
                                             str(work / f"resume_{label.replace(' ', '_')}")])
        params = [p for group in trainer.optimizer.param_groups for p in group["params"]]
        runs[label] = {"state": {k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
                       "adam": [None if p not in trainer.optimizer.state else
                                (float(trainer.optimizer.state[p]["step"]), trainer.optimizer.state[p]["exp_avg"].clone(),
                                 trainer.optimizer.state[p]["exp_avg_sq"].clone()) for p in params],
                       "losses": [h["scalars"] for h in trainer.history if h["mode"] == "train"],
                       "opt_steps": trainer.opt_steps, "lr": trainer.lr_at(trainer.opt_steps - 1)}
        del trainer
    a, b, c = runs["msgpack"], runs["pth"], runs["pth again"]
    if a["opt_steps"] != b["opt_steps"] or a["losses"] != b["losses"]:
        raise SystemExit(f"resumed steps differ: Adam steps {a['opt_steps']} / {b['opt_steps']}, losses "
                         f"{a['losses']} / {b['losses']}")

    def differ(x, y):
        return [k for k in x["state"] if not torch.equal(x["state"][k], y["state"][k])]

    def adam_differ(x, y):
        return sum((sx is None) != (sy is None) or (sx is not None and not (
            sx[0] == sy[0] and torch.equal(sx[1], sy[1]) and torch.equal(sx[2], sy[2])))
            for sx, sy in zip(x["adam"], y["adam"]))

    moved, repeat = differ(a, b), differ(b, c)
    print(f"  one fine_tune step resumed with --resume_optim from each folder: Adam's count {a['opt_steps']} on both, "
          f"train losses bit-equal (loss {a['losses'][0]['loss']:.6f}); weights and Adam state after the step: "
          f".msgpack vs .pth {len(moved)} of {len(a['state'])} state entries and {adam_differ(a, b)} Adam entries "
          f"not bit-equal; .pth vs .pth again {len(repeat)} and {adam_differ(b, c)}")
    if moved and not repeat:
        raise SystemExit(f"the step from the .msgpack folder differs from the .pth folder's, which repeats: {moved[:5]}")

    def beyond(x, y):
        """State entries further apart than one Adam step's round-off: 1e-2
        of its learning rate plus 2 float32 spacings of the value
        (tests/test_torch_train_step.py's bound)."""
        out = []
        for k, u in x["state"].items():
            v = y["state"][k]
            if not u.is_floating_point():
                out += [] if torch.equal(u, v) else [k]
                continue
            tol = 1e-2 * x["lr"] + 2 * torch.finfo(u.dtype).eps * torch.maximum(u.abs(), v.abs())
            out += [k] if bool(((u - v).abs() > tol).any()) else []
        return out

    if moved:
        worst = max(float((a["state"][k] - b["state"][k]).abs().max()) for k in moved)
        spread = max(float((b["state"][k] - c["state"][k]).abs().max()) for k in repeat)
        far, far_repeat = beyond(a, b), beyond(b, c)
        print(f"  not bitwise repeatable on the card: max abs state difference {worst:.3e} (.msgpack vs .pth), "
              f"{spread:.3e} (.pth vs .pth again); entries beyond 1e-2 of the learning rate ({a['lr']:.1e}) plus 2 "
              f"float32 spacings: {len(far)} and {len(far_repeat)}")
        if far:
            raise SystemExit(f"the step from the .msgpack folder lies beyond one step's round-off of the .pth "
                             f"folder's: {far[:5]}")
    # The same two resumed steps on the CPU, whose step repeats bitwise (at
    # 96x320: the weights do not depend on the size), must be bit-equal.
    cpu_runs = {}
    small = resume[:resume.index("--height")] + ["--height", "96", "--width", "320"] + \
        resume[resume.index("--batch_size"):]
    for label, path in (("msgpack", jax_folder), ("pth", folder)):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            trainer = train_entry.main(small + ["--load_ckpt", str(path), "--log_dir", str(work / f"cpu_{label}")],
                                       device="cpu")
        cpu_runs[label] = {"state": trainer.model.state_dict(),
                           "losses": [h["scalars"] for h in trainer.history if h["mode"] in ("train", "val")],
                           "adam": [t for s in trainer.optimizer.state.values() for t in (s["exp_avg"], s["exp_avg_sq"])]}
    x, y = cpu_runs["msgpack"], cpu_runs["pth"]
    cpu_differ = [k for k in x["state"] if not torch.equal(x["state"][k], y["state"][k])]
    if cpu_differ or x["losses"] != y["losses"] or len(x["adam"]) != len(y["adam"]) or \
            not all(map(torch.equal, x["adam"], y["adam"])):
        raise SystemExit(f"on the CPU the steps resumed from the two folders differ: {cpu_differ[:5]}")
    print(f"  the same two resumed steps on the CPU (96x320, where the step repeats bitwise): weights and Adam state "
          f"bit-equal ({len(x['state'])} state entries, {len(x['adam'])} Adam moments), losses equal")
    return {"files": files, "bytes": size, "write_s": write_s, "eval_s": eval_s, "bit_equal": not moved,
            "repeatable": not repeat, "state_entries_differing": len(moved), "repeat_entries_differing": len(repeat)}


# Phase 12c: update norms, card against CPU. Adam's first step moves each
# weight by about lr * sign(g), so a module's norm counts its weights; it
# moves only where the two devices' gradients differ in sign, near zeros of
# the gradient (found 2e-5 between the JAX package and the port on the CPU).
UPDATE_NORM_TOL = 1e-3


def run_grad_compare(smi, work):
    """12c: ``bench/grad_compare.py`` at its defaults on the card and on the
    CPU (drop-path off and the RANSAC draws shared, as phase 5 runs its
    step), then ``--diff``."""
    import torch

    from dynamo_depth_torch.bench import grad_compare
    from dynamo_depth_torch.models.layers import DropPath
    from dynamo_depth_torch.ops import ground_plane

    def no_drop_path(trainer):
        for m in trainer.model.modules():
            if isinstance(m, DropPath):
                m.rate = 0.0

    recs, wall = {}, {}
    draw = ground_plane.draw_sample_idx
    for device in ("cuda", "cpu"):
        args = grad_compare.build_parser().parse_args(["--device", device, "--out", str(work / f"gc_{device}.json")])
        idx_gen = torch.Generator().manual_seed(1)
        ground_plane.draw_sample_idx = lambda b, t, n, g, device: torch.randint(0, n, (b, t), generator=idx_gen).to(device)
        log = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                recs[device] = grad_compare.run(args, setup=no_drop_path)
        finally:
            ground_plane.draw_sample_idx = draw
        wall[device] = time.perf_counter() - t0
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        grad_compare.diff([str(work / "gc_cpu.json"), str(work / "gc_cuda.json")])
    print(f"12c: python -m dynamo_depth_torch.bench.grad_compare at its defaults (fine_tune, 96x320, batch 6, "
          f"drop-path off, shared RANSAC draws) on the card ({wall['cuda']:.1f} s) and the CPU ({wall['cpu']:.1f} s), "
          f"then --diff:")
    print("  " + table.getvalue().rstrip().replace("\n", "\n  "))
    card, cpu = recs["cuda"], recs["cpu"]
    rel = {k: abs(card["losses"][k] - cpu["losses"][k]) / max(abs(cpu["losses"][k]), 1e-6) for k in cpu["losses"]}
    worst = max((k for k in rel if k not in RANSAC_TERMS), key=rel.get)
    agree(f"grad_compare loss terms outside RANSAC (worst {worst}; d_ground {rel['loss_term/d_ground']:.2e}, "
          f"recorded)", rel[worst], 1e-4)
    norm_rel = {k: abs(card["update_norms"][k] - v) / v for k, v in cpu["update_norms"].items()}
    agree(f"grad_compare update norms (worst {max(norm_rel, key=norm_rel.get)})", max(norm_rel.values()),
          UPDATE_NORM_TOL)
    if card["platform"] != "cuda" or card.keys() != {"platform", "phase", "losses", "update_norms"}:
        raise SystemExit(f"grad_compare wrote {sorted(card)} on {card['platform']}")
    return {"loss_rel": rel, "norm_rel": norm_rel, "wall_s": wall}


def run_profile_tool(smi, work, folder):
    """12d: a ``--profile`` trace of one fine_tune epoch of 2 steps from
    12a's last folder, read by ``bench/profile_top_ops.py``."""
    from dynamo_depth_torch import train as train_entry
    from dynamo_depth_torch.bench import profile_top_ops

    root = Path(__file__).resolve().parent
    steps = 2
    argv = ["-d", "kitti", "-n", "profiled", "--data_path", str(root / "assets" / "tiny_kitti") + "/", "--split",
            "tiny_kitti", "--height", str(H), "--width", str(W), "--batch_size", str(B), "--weights_init", "scratch",
            "--epoch_schedules", "0", "0", "0", "1", "--epoch-size", str(steps), "--log_frequency", "1",
            "--no_train_vis", "--print_opt", "", "--load_ckpt", str(folder), "--log_dir", str(work / "logs"),
            "--profile"]
    trainer = train_entry.main(argv)
    vals = sum(h["mode"] == "val" for h in trainer.history)
    trace = work / "logs" / "profiled" / "traces" / "fine_tune"
    print(f"12d: python -m dynamo_depth_torch.bench.profile_top_ops {trace} 8 ({steps} fine_tune steps and {vals} "
          f"validation batches, traced on the card):")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        summary = profile_top_ops.main([str(trace), "8"])
    for flag in ("--by-op", "--copies"):
        with contextlib.redirect_stdout(log):
            profile_top_ops.main([str(trace), "8", flag])
    print("  " + log.getvalue().rstrip().replace("\n", "\n  "))
    # The steps launch each kernel 6 times; each validation batch's forward
    # launches K1 and K3 6 times more.
    per = launches_per_step(trainer.cfg)
    expected = {"warp_fwd": per["warp_fwd"] * (steps + vals), "warp_bwd": per["warp_bwd"] * steps,
                "photometric_fwd": per["photometric_fwd"] * (steps + vals),
                "photometric_bwd": per["photometric_bwd"] * steps}
    got = {k: summary["categories"].get(k, [0.0, 0])[1] for k in expected}
    if got != expected:
        raise SystemExit(f"profile_top_ops counted {got} launches, expected {expected}")
    print(f"  the four port kernels in the tool's table: {got} launches (6 per step each, and 6 of K1 and K3 per "
          f"validation batch); {summary['total_ms']:.1f} ms of device time in the trace, on {smi}")
    return {"launches": got, "total_ms": summary["total_ms"],
            "ms": {k: summary["categories"][k][0] for k in expected}}


def run_phase12(smi, phase7, phase8_tables):
    """Phase 12: the training visualisation (12a), a JAX-layout checkpoint
    (12b), ``bench/grad_compare.py`` (12c) and ``bench/profile_top_ops.py``
    (12d) on the card."""
    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / "phase12"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    vis = run_vis(smi, work)
    jax_folder = run_jax_folder(smi, work, Path(phase7["folder"]), phase8_tables["kitti"])
    grad = run_grad_compare(smi, work)
    prof = run_profile_tool(smi, work, vis["folder"])
    wall = time.perf_counter() - t0
    print(f"phase 12: {wall:.1f} s")
    return {"vis": vis, "jax_folder": jax_folder, "grad_compare": grad, "profile_tool": prof, "wall_s": wall}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from dynamo_depth_torch.bench.timing import device_ms, median_ms
    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.ops.kernels import build, photometric, warp
    from dynamo_depth_torch.ops.geometry import pixel_grid
    from dynamo_depth_torch.training.synthetic import ego_motion_grid, synthetic_batch
    from dynamo_depth_torch.training.trainer import Trainer

    # ---- 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} | CUDA {torch.version.cuda} | device {name} | count {torch.cuda.device_count()}")
    mem_rate, f32_rate = card_rates(name)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(built) or 'all current'})")
    for src, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}.cu ptxas: {line.strip()}")

    # ---- 3. kernels against their plain versions ---------------------------
    print(f"kernels vs plain at B={B} C={C} {H}x{W}:")
    gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.rand(B, C, H, W, device=dev, generator=gen)
    # [-1.1, 1.1]: ~5% of samples per axis land beyond the border.
    grid = torch.rand(B, H, W, 2, device=dev, generator=gen) * 2.2 - 1.1
    g_warp = torch.randn(B, C, H, W, device=dev, generator=gen)
    pred = torch.rand(B, C, H, W, device=dev, generator=gen)
    target = torch.rand(B, C, H, W, device=dev, generator=gen)
    g_photo = torch.randn(B, 1, H, W, device=dev, generator=gen)
    ego = ego_motion_grid(B, H, W, seed=0).to(dev)
    errors = {}

    def scale_tol(ref, rel=1e-5):
        return rel * max(1.0, float(ref.abs().max()))

    errors["warp_fwd"] = errors["warp_bwd"] = 0.0
    for label, gr in (("uniform grid", grid), ("ego-motion grid", ego)):
        out_k = warp.warp_fwd(img, gr)
        img_r, grid_r = img.clone().requires_grad_(), gr.clone().requires_grad_()
        out_p = warp.grid_sample_plain(img_r, grid_r)
        d_img_p, d_grid_p = torch.autograd.grad(out_p, (img_r, grid_r), g_warp)
        img_l, grid_l = img.clone().requires_grad_(), gr.clone().requires_grad_()
        out_l = F.grid_sample(img_l, grid_l, mode="bilinear", padding_mode="border", align_corners=True)
        d_img_l, d_grid_l = torch.autograd.grad(out_l, (img_l, grid_l), g_warp)
        d_img_k, d_grid_k = warp.warp_bwd(img, gr, g_warp, True)
        _, d_grid_k2 = warp.warp_bwd(img, gr, g_warp, False)
        torch.cuda.synchronize()
        # Values: one lerp, float32 with or without fused multiply-adds.
        err = max_err(out_k, out_p)
        errors["warp_fwd"] = max(errors["warp_fwd"], err)
        check(f"warp_fwd vs plain ({label})", err, 1e-5)
        check(f"warp_fwd vs F.grid_sample ({label})", max_err(out_k, out_l), 1e-5)
        # d_grid is a 3-term sum scaled by (W-1)/2 = 319.5: 1e-5 of its scale.
        err = max(max_err(d_grid_k, d_grid_p), max_err(d_grid_k2, d_grid_p))
        errors["warp_bwd"] = max(errors["warp_bwd"], err)
        check(f"warp_bwd d_grid vs plain ({label})", err, scale_tol(d_grid_p))
        check(f"warp_bwd d_grid vs F.grid_sample ({label})", max_err(d_grid_k, d_grid_l), scale_tol(d_grid_l, 1e-4))
        # d_image: atomicAdd sums in no fixed order.
        check(f"warp_bwd d_image vs plain ({label})", max_err(d_img_k, d_img_p), scale_tol(d_img_p))
        check(f"warp_bwd d_image vs F.grid_sample ({label})", max_err(d_img_k, d_img_l), scale_tol(d_img_l))

    out_k = photometric.photometric_fwd(pred, target, 0.85)
    pred_r, target_r = pred.clone().requires_grad_(), target.clone().requires_grad_()
    out_p = photometric.reprojection_loss_plain(pred_r, target_r, 0.85)
    d_pred_p, d_target_p = torch.autograd.grad(out_p, (pred_r, target_r), g_photo)
    d_pred_k, d_target_k = photometric.photometric_bwd(pred, target, g_photo, 0.85, True)
    d_pred_k2, _ = photometric.photometric_bwd(pred, target, g_photo, 0.85, False)
    torch.cuda.synchronize()
    # SSIM from 3x3 window sums in another order: a few ulps, amplified by
    # the variance ratios.
    errors["photometric_fwd"] = max_err(out_k, out_p)
    check("photometric_fwd vs plain", errors["photometric_fwd"], 1e-5)
    errors["photometric_bwd"] = max(max_err(d_pred_k, d_pred_p), max_err(d_pred_k2, d_pred_p))
    check("photometric_bwd d_pred vs plain", errors["photometric_bwd"], scale_tol(d_pred_p, 1e-4))
    check("photometric_bwd d_target vs plain", max_err(d_target_k, d_target_p), scale_tol(d_target_p, 1e-4))

    # Exact ties. K4 where pred equals target: jnp.abs's subgradient 1 at 0
    # gives the L1 term -(1 - w) / C * g in d_pred, where the SSIM term
    # vanishes. K2 where the grid lies exactly on the border: jnp.clip passes
    # half the coordinate gradient there.
    pred_r, target_r = pred.clone().requires_grad_(), pred.clone().requires_grad_()
    out_p = photometric.reprojection_loss_plain(pred_r, target_r, 0.85)
    d_pred_p, d_target_p = torch.autograd.grad(out_p, (pred_r, target_r), g_photo)
    d_pred_k, d_target_k = photometric.photometric_bwd(pred, pred, g_photo, 0.85, True)
    torch.cuda.synchronize()
    err = max(max_err(d_pred_k, d_pred_p), max_err(d_target_k, d_target_p))
    errors["photometric_bwd"] = max(errors["photometric_bwd"], err)
    check(f"photometric_bwd where pred == target (|d_pred| up to {float(d_pred_p.abs().max()):.3f})",
          err, scale_tol(d_pred_p, 1e-4))
    on_border = grid.clamp(-1.0, 1.0)
    img_r, grid_r = img.clone().requires_grad_(), on_border.clone().requires_grad_()
    out_p = warp.grid_sample_plain(img_r, grid_r)
    d_img_p, d_grid_p = torch.autograd.grad(out_p, (img_r, grid_r), g_warp)
    d_img_k, d_grid_k = warp.warp_bwd(img, on_border, g_warp, True)
    torch.cuda.synchronize()
    err = max_err(d_grid_k, d_grid_p)
    errors["warp_bwd"] = max(errors["warp_bwd"], err)
    ties = int((on_border.abs() == 1.0).sum())
    check(f"warp_bwd d_grid on a grid with {ties} entries of exactly -1 or 1", err, scale_tol(d_grid_p))
    check("warp_bwd d_image on that grid", max_err(d_img_k, d_img_p), scale_tol(d_img_p))

    # ---- 4. timing ---------------------------------------------------------
    P = B * H * W

    def displacement(gr):
        """How far each output pixel samples from itself, in source pixels."""
        px = (gr + 1.0) * 0.5 * torch.tensor([W - 1.0, H - 1.0], device=dev)
        shift = (px - pixel_grid(H, W, dev)[:, :2].reshape(1, H, W, 2)).norm(dim=-1)
        return f"displacement max {float(shift.max()):.2f} px, median {float(shift.median()):.2f} px"

    print(f"ego-motion grid: {displacement(ego)}")
    pred_req = pred.clone().requires_grad_()
    out_plain_ph = photometric.reprojection_loss_plain(pred_req, target, 0.85)
    # bytes and float32 operations per output pixel at C = 3 (each input
    # read once, each output written once)
    work = {
        "warp_fwd": (8 + 4 * C + 4 * C, 12 + 5 * C),
        "warp_bwd": (8 + 4 * C + 4 * C + 8, 14 + 10 * C),
        "photometric_fwd": (4 * C + 4 * C + 4, C * (5 * 9 + 20) + 6),
        "photometric_bwd": (4 * C + 4 * C + 4 + 4 * C, C * (5 * 9 + 40 + 4 * 9 * 2 + 12)),
    }

    def warp_calls(gr):
        g_req = gr.clone().requires_grad_()
        out_plain = warp.grid_sample_plain(img, g_req)
        out_lib = F.grid_sample(img, g_req, mode="bilinear", padding_mode="border", align_corners=True)
        return {
            "warp_fwd": (
                lambda: warp.warp_fwd(img, gr),
                lambda: warp.grid_sample_plain(img, gr),
                lambda: F.grid_sample(img, gr, mode="bilinear", padding_mode="border", align_corners=True),
            ),
            "warp_bwd": (
                lambda: warp.warp_bwd(img, gr, g_warp, False),
                lambda: torch.autograd.grad(out_plain, g_req, g_warp, retain_graph=True),
                lambda: torch.autograd.grad(out_lib, g_req, g_warp, retain_graph=True),
            ),
        }

    calls = {}  # (kernel, grid): kernel, plain version, library call (None: no single call)
    for label, gr in (("uniform", grid), ("ego", ego)):
        calls.update({(k, label): fns for k, fns in warp_calls(gr).items()})
    calls[("photometric_fwd", None)] = (
        lambda: photometric.photometric_fwd(pred, target, 0.85),
        lambda: photometric.reprojection_loss_plain(pred, target, 0.85),
        None,
    )
    calls[("photometric_bwd", None)] = (
        lambda: photometric.photometric_bwd(pred, target, g_photo, 0.85, False),
        lambda: torch.autograd.grad(out_plain_ph, pred_req, g_photo, retain_graph=True),
        None,
    )
    # ms: device time (all kernels of one call, torch.profiler); wall_ms:
    # CUDA events around one call, which include the host's launch overhead.
    # cold: the kernel and the library call with a cold L2.
    timings, wall, cold = {}, {}, {}
    for key, fns in calls.items():
        dev_t = [None if fn is None else device_ms(fn) for fn in fns]
        wall_t = [None if fn is None else median_ms(fn) for fn in fns]
        # Without device activity in the profile, fall back to the events.
        timings[key] = [d if d is not None or w is None else w for d, w in zip(dev_t, wall_t)]
        wall[key] = wall_t
        cold[key] = [None if fn is None else device_ms(fn, cold=True) for fn in (fns[0], fns[2])]
    del calls, out_plain_ph
    bounds = {}
    print(f"timing (ms; device time from the profiler, wall = events around one call) at B={B} C={C} {H}x{W} on {smi}:")
    for (k, label), (ms, plain_ms, lib_ms) in timings.items():
        nbytes, nops = work[k][0] * P, work[k][1] * P
        t_bytes, t_ops = nbytes / mem_rate * 1e3, nops / f32_rate * 1e3
        bounds[k] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        w = wall[(k, label)]
        plain = "n/a" if plain_ms is None else f"{plain_ms:.4f} (wall {w[1]:.4f})"
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} (wall {w[2]:.4f})"
        where = "" if label is None else f" [{label} grid]"
        c_ms, c_lib = cold[(k, label)]
        lib_cold = "" if lib_ms is None else f", library {fmt_ms(c_lib)}"
        print(f"  {k}{where}: kernel {ms:.4f} (wall {w[0]:.4f}) | plain {plain} "
              f"| library {lib} | bound {bounds[k][0]:.4f} ({bounds[k][1]}) | cold L2: kernel {fmt_ms(c_ms)}{lib_cold}")

    # ---- 5. the step on the card against the step on the CPU --------------
    card_vs_cpu_step(DynamoConfig(dataset="kitti", height=64, width=96, batch_size=2, weights_init="scratch"))

    # ---- 6. the main path: fine_tune at 192x640, batch 3 -------------------
    smoke_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(smoke_dir, ignore_errors=True)
    smoke_dir.mkdir(parents=True)
    cfg = DynamoConfig(dataset="kitti", depth_model="litemono", batch_size=B, weights_init="scratch")
    trainer = Trainer(cfg)  # the card, float32, drop-path 0.4
    batch = trainer.to_device(synthetic_batch(cfg, B, cfg.height, cfg.width))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    main_path = timed_steps(trainer, batch, gen, smi, "LiteMono float32")
    ms, counts, peak, steps = main_path["ms"], main_path["launches"], main_path["peak_bytes"], main_path["steps"]

    # where the step's device time goes (one extra step, profiled)
    profiled = profiled_step(trainer, batch, gen, steps, ms, top=15)
    in_step = profiled["in_step_ms"]
    for k in in_step:
        bench = timings[(k, "ego" if k.startswith("warp") else None)][0]
        print(f"  {k}: {in_step[k]:.4f} ms per launch in the step (x{profiled['launches'][k]}), {bench:.4f} ms alone"
              f"{' on the ego-motion grid' if k.startswith('warp') else ''}")

    # ---- the warp's inputs in the step (one extra step, captured) ----------
    captured = []
    launch_fwd = warp.warp_fwd

    def capture(image, gr):
        captured.append((image.detach().clone(), gr.detach().clone()))
        return launch_fwd(image, gr)

    warp.warp_fwd = capture
    try:
        trainer.train_step(batch, gen, steps + 1)
    finally:
        warp.warp_fwd = launch_fwd
    if len(captured) != 6 or any(im.shape != img.shape or gr.shape != grid.shape for im, gr in captured):
        raise SystemExit(f"captured {len(captured)} warp inputs of the step, expected 6 of {tuple(img.shape)}")
    torch.save({"images": [im.cpu() for im, _ in captured], "grids": [gr.cpu() for _, gr in captured]},
               smoke_dir / "step_warp_inputs.pt")
    # device ms alone on each captured input, with a warm and a cold L2: the
    # kernels, and the library's forward and backward (grid_sampler_2d,
    # d_grid only, as in the step)
    on_step = {"warp_fwd": [], "warp_bwd": []}
    lib_step = {"warp_fwd": [], "warp_bwd": []}
    on_step_cold = {"warp_fwd": [], "warp_bwd": []}
    lib_step_cold = {"warp_fwd": [], "warp_bwd": []}
    print(f"the step's warp inputs, kernels and F.grid_sample alone on each (device ms; in the step: "
          f"warp_fwd {in_step['warp_fwd']:.4f}, warp_bwd {in_step['warp_bwd']:.4f} per launch):")
    for i, (im, gr) in enumerate(captured):
        if not bool(torch.isfinite(gr).all()):
            raise SystemExit(f"step grid {i} is not finite")
        g_req = gr.clone().requires_grad_()
        out_lib = F.grid_sample(im, g_req, mode="bilinear", padding_mode="border", align_corners=True)
        fns = {
            "warp_fwd": (lambda: warp.warp_fwd(im, gr),
                         lambda: F.grid_sample(im, gr, mode="bilinear", padding_mode="border", align_corners=True)),
            "warp_bwd": (lambda: warp.warp_bwd(im, gr, g_warp, False),
                         lambda: torch.autograd.grad(out_lib, g_req, g_warp, retain_graph=True)),
        }
        for k, (kernel_fn, lib_fn) in fns.items():
            on_step[k].append(device_ms(kernel_fn))
            lib_step[k].append(device_ms(lib_fn))
            on_step_cold[k].append(device_ms(kernel_fn, cold=True))
            lib_step_cold[k].append(device_ms(lib_fn, cold=True))
        print(f"  grid {i}: {displacement(gr)}; " + ", ".join(
            f"{k} {fmt_ms(on_step[k][i])} (library {fmt_ms(lib_step[k][i])}; cold L2 {fmt_ms(on_step_cold[k][i])}, "
            f"library {fmt_ms(lib_step_cold[k][i])})" for k in fns))
    for k in on_step:
        ours, lib = mean_ms(on_step[k]), mean_ms(lib_step[k])
        print(f"  {k} on the step's grids: mean {fmt_ms(ours)} ms, library {fmt_ms(lib)} ms; cold L2: "
              f"{fmt_ms(mean_ms(on_step_cold[k]))} ms, library {fmt_ms(mean_ms(lib_step_cold[k]))} ms")
    del captured, out_lib

    # ---- 7. the curriculum from the port's entry point, on tiny_kitti -----
    phase7 = run_curriculum(smi)

    # ---- 8. the eval path from phase 7's last checkpoint -------------------
    print(f"eval path: the four eval CLIs and the quick demo from {phase7['folder']}, on the card and on the CPU:")
    phase8 = run_eval(smi, phase7["folder"], phase7["work"])

    # ---- 9. monodepthv2: the step, the curriculum and depth eval ----------
    phase9 = run_monodepthv2(smi, phase7["work"])

    # ---- 10. bfloat16: the LiteMono step against float32 -------------------
    phase10 = run_bf16(smi, main_path, profiled)

    # ---- 11. data parallelism: torchrun, NCCL at world size 1, two gloo ranks
    print("data parallelism (phase 11):")
    phase11 = run_ddp(smi, phase7, phase8["tables"])
    gloo_main = phase11["gloo2"][0]["main_path"]

    # ---- 12. the training visualisation, JAX folders and the bench tools ---
    print("phase 12:")
    phase12 = run_phase12(smi, phase7, phase8["tables"])

    # ---- kernels line, result line -----------------------------------------
    sources = {
        "warp_fwd": ("dynamo_depth_torch/csrc/warp.cu", "dynamo_depth_tpu/ops/pallas/warp_kernel.py:57"),
        "warp_bwd": ("dynamo_depth_torch/csrc/warp.cu", "dynamo_depth_tpu/ops/pallas/warp_kernel.py:126"),
        "photometric_fwd": ("dynamo_depth_torch/csrc/photometric.cu", "dynamo_depth_tpu/ops/pallas/photometric_kernel.py:62"),
        "photometric_bwd": ("dynamo_depth_torch/csrc/photometric.cu", "dynamo_depth_tpu/ops/pallas/photometric_kernel.py:116"),
    }
    kernels = []
    for k, (src, replaces) in sources.items():
        warp_k = k.startswith("warp")
        ms_k, plain_ms, lib_ms = timings[(k, "uniform" if warp_k else None)]
        entry = {
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": phase7["launches"][k], "launches_per_step_by_phase": phase7["per_step"][k],
            "launches_fine_tune_steps": counts[k], "launches_per_step": counts[k] / steps, "max_abs_err": errors[k],
            "ms": ms_k, "plain_ms": plain_ms, "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
            "library_ms": lib_ms, "wall_ms": wall[(k, "uniform" if warp_k else None)][0],
            "in_step_ms": in_step[k], "launches_eval": phase8["launches"][k],
            "launches_per_step_monodepthv2": phase9["step"]["launches"][k] / phase9["step"]["steps"],
            "launches_per_step_by_phase_monodepthv2": phase9["curriculum"]["per_step"][k],
            "in_step_ms_monodepthv2": phase9["profiled"]["in_step_ms"][k],
            "launches_per_step_bf16": phase10["step"]["launches"][k] / phase10["step"]["steps"],
            "in_step_ms_bf16": phase10["profiled"]["in_step_ms"][k],
            "launches_ddp_world1": phase11["nccl1"]["launches"][k],
            "launches_per_step_by_phase_ddp_world1": phase11["nccl1"]["per_step"][k],
            "launches_gloo2_rank0": gloo_main["launches"][k],
            "launches_per_rank_step_gloo2": gloo_main["launches_per_step"][0][k],
            "ms_cold": cold[(k, "uniform" if warp_k else None)][0],
            "library_ms_cold": cold[(k, "uniform" if warp_k else None)][1],
            "launches_per_log_vis": phase12["vis"]["launches_per_log_vis"][k],
            "launches_vis_curriculum": phase12["vis"]["launches"][k],
            "launches_profile_tool": phase12["profile_tool"]["launches"][k],
        }
        if warp_k:  # "ms", "plain_ms", "library_ms" above are on the uniform grid
            ms_e, plain_e, lib_e = timings[(k, "ego")]
            entry.update({"ms_ego_grid": ms_e, "plain_ms_ego_grid": plain_e, "library_ms_ego_grid": lib_e,
                          "wall_ms_ego_grid": wall[(k, "ego")][0],
                          "ms_ego_grid_cold": cold[(k, "ego")][0], "library_ms_ego_grid_cold": cold[(k, "ego")][1],
                          "ms_step_grids": mean_ms(on_step[k]), "library_ms_step_grids": mean_ms(lib_step[k]),
                          "ms_step_grids_cold": mean_ms(on_step_cold[k]),
                          "library_ms_step_grids_cold": mean_ms(lib_step_cold[k])})
        kernels.append(entry)
    summary = {"float32": {"ms": ms, "busy_ms": profiled["busy_ms"], "peak_bytes": peak},
               "monodepthv2": {"ms": phase9["step"]["ms"], "busy_ms": phase9["profiled"]["busy_ms"],
                               "peak_bytes": phase9["step"]["peak_bytes"], "curriculum": phase9["curriculum"]["summary"],
                               "depth_eval_s": phase9["depth_eval_s"]},
               "bfloat16": {"ms": phase10["step"]["ms"], "busy_ms": phase10["profiled"]["busy_ms"],
                            "peak_bytes": phase10["step"]["peak_bytes"], "loss_rel_err": phase10["rel"]},
               "ddp_world1_nccl": {p: r["ms_per_step"] for p, r in phase11["nccl1"]["summary"]["phases"].items()},
               "gloo2_shared_card": {"step_ms": gloo_main["step_ms"],
                                     "allreduce_bytes_per_step": gloo_main["allreduce_bytes_per_step"],
                                     "card_vs_cpu_rel": phase11["gloo2"][0]["card_vs_cpu"]["rel"]},
               "ddp_wall_s": phase11["wall_s"],
               "phase12": {"log_vis_ms": phase12["vis"]["vis_ms"], "step_ms": phase12["vis"]["step_ms"],
                           "vis_grids_ms_one_batch": phase12["vis"]["grid_ms_one_batch"],
                           "jax_folder": phase12["jax_folder"],
                           "grad_compare": {"loss_rel": phase12["grad_compare"]["loss_rel"],
                                            "norm_rel": phase12["grad_compare"]["norm_rel"]},
                           "profile_tool_ms": phase12["profile_tool"]["ms"], "wall_s": phase12["wall_s"]}}
    print(json.dumps({"kernels": kernels, "step_ms": ms, "examples_per_s": B / ms * 1e3,
                      "peak_bytes": peak, "curriculum": phase7["summary"], "eval": phase8, "steps": summary,
                      "card": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--ddp-worker":  # a rank of a phase-11 launch
        sys.exit(ddp_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
