#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: every check holds
the port on the card to its plain versions, to the CPU or to its contracts.
The port is timed by ``python3 -m benchmark.run`` (``BENCHMARK.json``), not
here.

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
   ``training/synthetic.py::ego_motion_grid``);
4. the same at exact ties, where the kernels take the JAX package's
   subgradients as the plain versions do: K4 where pred equals target on a
   textured image, K2 on a grid whose entries beyond the border are clipped
   to exactly -1 or 1;
5. one ``fine_tune`` step on the card against the same step on the CPU (the
   plain versions) from the same weights at 64x96;
6. the main path: the LiteMono ``fine_tune`` step at 192x640, batch 3,
   float32 (KITTI headline config, random weights from seed 0): 7 steps
   with finite losses, moving weights, and the launches per step of each of
   the four kernels that ``cfg.scales`` gives (2 source frames per scale:
   6); then one more step whose six warp inputs are captured: images of the
   batch's shape and finite grids;
7. the curriculum from the port's entry point,
   ``dynamo_depth_torch.train.main``, on the vendored ``assets/tiny_kitti``
   (LiteMono, 192x640, batch 3, float32, one epoch of 3 steps per phase, one
   validation batch per step, a split under ``build/chip_smoke``): which
   decoder loaded the images, each phase's kernel launches per step against
   the count that phase must make, finite losses, the trainable modules'
   weights moved and the frozen ones' bit-identical, peak memory, four
   checkpoint folders in the reference's layout, ``fine_tune_00`` loaded
   into a fresh trainer with the same state dict, and one more
   ``fine_tune`` step from it with ``--load_ckpt ... --resume_optim``;
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
   run, its peak memory, the plot files written and not written;
9. monodepthv2 (ResNet-18 depth encoder, Monodepth2 decoder, 4 scales):
   the 64x96 step on the card against the CPU as in phase 5; the
   ``fine_tune`` step at 192x640, batch 3, float32, checked as phase 6 with
   8 launches per step of each kernel; the curriculum from the entry point
   on tiny_kitti with ``--depth_model monodepthv2``, 2 steps per phase (8
   launches per step, 16 of K3 in disp_init), checked as phase 7;
   ``eval.depth`` of its ``fine_tune_00`` on the card and the CPU, tables
   compared as in phase 8;
10. bfloat16: the LiteMono ``fine_tune`` step at 192x640, batch 3, with
   ``compute_dtype="bfloat16"`` from phase 6's seed-0 weights: one step
   against a float32 step from the same weights, batch and draws (each loss
   term that RANSAC does not enter within ``BF16_LOSS_TOL``; d_ground and
   the totals finite), then checked as phase 6 (still 6 launches per step:
   the kernels take the float32 outputs); one bfloat16 monodepthv2 step
   with finite losses;
11. data parallelism over ``torch.distributed``, each launch a subprocess
   ``python -m torch.distributed.run ... chip_smoke.py --ddp-worker <name>
   <dir>`` killed after ``DDP_TIMEOUT_S``: (a) at world size 1 over NCCL,
   the curriculum from the entry point as phase 7 runs it (2 steps per
   phase, the launches per step, weights moved or bit-identical,
   checkpoints) through ``DistributedDataParallel``; (b) two ranks sharing
   the card over gloo (NCCL refuses two ranks on one card): 3 ``fine_tune``
   steps at 192x640, batch 3 per rank, 6 launches of each kernel per
   rank-step, parameters and BatchNorm buffers bit-identical across the
   ranks after every step, and the bytes all-reduced per step; the same two
   ranks at 64x96 on the card against the two on the CPU, the loss terms
   RANSAC does not enter at phase 5's tolerance (the others recorded); (c)
   ``eval.depth`` with the two ranks, its tables equal to phase 8's
   one-process tables;
12. (a) the training visualisation: the curriculum from the entry point on
   tiny_kitti at 192x640, batch 3, one step per phase, without
   ``--no_train_vis`` and with a recording stand-in for wandb in
   ``sys.modules`` (never the real one: no network): per step 3 grids of
   576x1920x3, finite, in [0, 1], the train and val scalars under the JAX
   package's names, 6 launches of K1 and none of K2-K4 in each ``log_vis``
   call; ``vis_grids`` of one batch on the card against the CPU from the
   same weights (``VIS_TOL`` on the first two rows, the colour wheels as
   phase 8 holds frames); (b) phase 7's last folder with its Adam state
   written in the JAX package's ``.msgpack`` layout: ``eval.depth`` from it
   equal to phase 8's table, and one ``fine_tune`` step resumed from each
   folder (and once more from the ``.pth`` one, which says how far the
   card's step repeats bitwise): bit-equal losses, the states within one
   Adam step's round-off, and the same two steps bit-equal on the CPU; (c)
   ``bench/grad_compare.py`` at its defaults on the card and the CPU, then
   ``--diff``: the terms outside RANSAC within phase 5's 1e-4, update norms
   within ``UPDATE_NORM_TOL``; (d) ``bench/profile_top_ops.py`` on a
   ``--profile`` trace of 2 ``fine_tune`` steps, its counts of the four
   kernels held to the steps' and the validation batches' launches;
13. (a) the pretrained init: random backbone files in the layouts it reads
   (a torchvision ResNet-18 state dict, ``fc.*`` included, and
   ``{"model": ..., "args": argparse.Namespace}`` for Lite-Mono-8M) under
   ``build/chip_smoke/phase13/ckpt``, and from that working directory the
   curriculum from the entry point at 192x640, batch 3, LiteMono, the
   default ``weights_init``, one step per phase: the files loaded once, and
   before the first step every encoder tensor equals the files' (conv1
   widened to the file's conv1 / n and to ``widen_conv1`` from
   ``RandomState(seed)`` on the CPU), launches per step as phase 7's;
   monodepthv2 from the same folder, its ``depth_enc`` the file's; with an
   empty ``ckpt/`` the JAX package's two messages and one ``fine_tune``
   step; (b) ``eval.depth -l ckpt/K_Dynamo-Depth`` through a stub ``gdown``
   on ``PATH`` that zips phase 7's last folder: its table equal to phase
   8's; with no ``gdown`` on ``PATH``, the FileNotFoundError naming the
   Google Drive id; (c) ``eval.motion_segmentation`` and ``eval.odometry``
   on two gloo ranks sharing the card, launched as in phase 11(b): counts
   and the FP tally within 1e-3 of the pixels and the odometry record
   within 1e-4 relative of phase 8's one-process records, rank 0 alone
   writing;
14. (a) the throughput CLI as a user runs it, ``python -m
   dynamo_depth_torch.bench.throughput`` (bfloat16 legs at batch 7, 8 and
   3) and again with ``--compute_dtype float32 --batch_size 3``: its last
   stdout line is the contract with a finite value > 0, every leg completed
   and launched each kernel 6 times per step, the warp's instances those of
   the operand dtype its batch picks under ``--image_dtype auto`` (bfloat16
   at b8, float32 at b3 and b7); (b) ``entry()`` on the card against
   ``entry(device="cpu")`` on the card's weights, its three outputs within
   ``ENTRY_RTOL``, no kernel launched; (c) ``python -m
   dynamo_depth_torch.entry 1`` (NCCL) and ``... 2 --backend=gloo`` (two
   ranks sharing the card): both arms completed (a budget skip fails here),
   finite losses;
15. K1's and K2's bfloat16-image instances at batch 8, 192x640, where
   ``--image_dtype auto`` casts the warp's source images to bfloat16: (b)
   the LiteMono ``fine_tune`` step with float32 networks, checked as phase
   6 with 6 launches per step of each bfloat16 instance and none of the
   float32 warp instances, and one more step whose six warp inputs are
   captured; (a) the instances against the plain version on the bfloat16
   image (a uniform grid, the ego-motion grid, a grid at the clamp's ties
   and the six step grids), and bit-equal to the float32 instances on the
   rounded image; (b) the step on the card against the same step on the
   CPU, phase 5's tolerances.

Prints the ``{"ok": true, "device": {...}}`` line last.
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
STEPS = 7  # fine_tune steps of each step check (phases 6, 9, 10 and 15b)


def max_err(a, b):
    return float((a - b).detach().abs().max())


def check(name, err, tol):
    ok = err <= tol
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.1e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")


def launches_per_step(cfg, phase="fine_tune"):
    """Launches of each kernel instance in one training step of ``phase``:
    one warp and one photometric error per scale and source frame (6 for
    LiteMono's 3 scales, 8 for monodepthv2's 4), and in disp_init as many
    photometric forwards again for the identity automask, whose inputs need
    no gradient. The warp's instances are those of the image dtype
    ``cfg.image_dtype`` picks for one card's batch (under auto bfloat16 from
    7 * 2**17 pixels: batch 8 at 192x640), the other two launch 0 times."""
    import torch

    from dynamo_depth_torch.config import warp_image_dtype

    n = len(cfg.scales) * (len(cfg.frame_ids) - 1)
    image = torch.empty(cfg.batch_size, 3, cfg.height, cfg.width, device="meta")
    suffix = "_bf16" if warp_image_dtype(cfg, image) == torch.bfloat16 else ""
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    counts.update({"warp_fwd" + suffix: n, "warp_bwd" + suffix: n,
                   "photometric_fwd": 2 * n if phase == "disp_init" else n, "photometric_bwd": n})
    return counts


# Every kernel instance the wrappers count, in the launch counts' order.
KERNEL_NAMES = ("warp_fwd", "warp_bwd", "warp_fwd_bf16", "warp_bwd_bf16", "photometric_fwd", "photometric_bwd")


def run_curriculum(smi, depth_model="litemono", steps=3, name="curriculum", reload=True, weights_init="scratch"):
    """Phases 7, 9, 11a and 13a: the curriculum from the entry point, ``steps``
    steps per phase (``weights_init`` None: the flag left at its default,
    which reads ``./ckpt``), then (``reload``) its last folder loaded into a fresh
    trainer and one more step from it. Returns {"per_step": {kernel: {phase:
    n}}, "folder": the last checkpoint folder, "wrappers": the type of the
    training wrapper at each step}; raises SystemExit on any failure."""
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
        "--batch_size", str(B), *(["--weights_init", weights_init] if weights_init else []),
        "--epoch_schedules", "1", "1", "1", "1", "--epoch-size", str(steps), "--log_frequency", "1",
        "--no_train_vis", "--log_dir", str(log_dir),
        "--print_opt", "",  # a bool flag of the reference's: the empty string is False
    ]
    print(f"curriculum: python -m dynamo_depth_torch.train {' '.join(argv)}")
    print(f"  native data plane: {'built' if native.available() else 'not built: ' + str(native.build_error).splitlines()[-1]}")

    # Per phase: each step's launches and losses, and the weights before and
    # after.
    records = {p: [] for p in trainer_mod.PHASES}
    weights = {}
    run_step, run_phase = trainer_mod.Trainer.train_step, trainer_mod.Trainer.run_phase

    def recorded_step(self, batch, generator, step):
        before = launch_counts()
        losses = run_step(self, batch, generator, step)
        after = launch_counts()
        records[self.phase].append({"launches": {k: after[k] - before[k] for k in after},
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
    zero = [k for k, n in launches.items() if n == 0 and launches_per_step(trainer.cfg)[k]]
    if zero:
        raise SystemExit(f"kernels never launched in the curriculum: {zero}")
    per_step = {k: {} for k in launches}
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
        print(f"  {phase}: {steps} steps, launches per step {recs[0]['launches']}, trainable "
              f"{'/'.join(trainable)} moved, the others bit-identical, loss {recs[-1]['losses']['loss']:.5f} "
              f"on {smi}")
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
        return {"per_step": per_step, "folder": str(last), "wrappers": wrappers}

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
    return {"per_step": per_step, "folder": last, "work": work, "wrappers": wrappers}


_FLOAT = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


def agree(what, err, tol, sides="card vs CPU"):
    print(f"  {what}: {sides} {err:.3e} (tolerance {tol:.0e}) {'ok' if err <= tol else 'FAILED'}")
    if not err <= tol:
        raise SystemExit(f"{what}: the records disagree ({sides})")


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


def run_eval(smi, folder, work):
    """Phase 8. Every eval CLI and the quick demo from ``folder`` on the card,
    then on the CPU, with the card's records held against the CPU's. Returns
    the card's records that phases 11-13 compare with; raises SystemExit on
    any failure."""
    import torch

    from dynamo_depth_torch import quick_demo
    from dynamo_depth_torch.bench.two_process_drive import ODOM_FRAMES, ODOM_SEG, build_odometry_segment
    from dynamo_depth_torch.eval import depth, motion_segmentation, odometry, visualize
    from dynamo_depth_torch.ops.kernels import launch_counts, reset_launch_counts

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

    return {"tables": {"kitti": card["depth_kitti"]["path"], "waymo": card["depth_waymo"]["path"]},
            "mot_seg": {"npz": mc["npz"], "fp_tally": {str(k): int(v) for k, v in mc["fp_tally"].items()},
                        **{k: mc[k].tolist() for k in ("tp", "fp", "fn")}},
            "odometry_npy": card["odometry"]["npy"]}


def card_vs_cpu_step(small):
    """Phases 5, 9 and 15b: one fine_tune step of ``small`` on the card
    (kernels) against the same step on the CPU (plain versions) from the
    same weights; raises SystemExit when a loss term disagrees. Returns
    {"rel": each term's relative difference, "launches": the card step's
    launch counts}."""
    import torch

    from dynamo_depth_torch.ops import ground_plane
    from dynamo_depth_torch.ops.kernels import launch_counts, reset_launch_counts
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
        reset_launch_counts()
        try:
            losses = tr.train_step(tr.to_device(batch_small), torch.Generator(device=tr.device).manual_seed(0), 5)
        finally:
            ground_plane.draw_sample_idx = draw
        results[label] = {k: float(v) for k, v in losses.items()}
        if label == "cuda":
            torch.cuda.synchronize()
            launches = launch_counts()
    rel = {k: abs(results["cuda"][k] - results["cpu"][k]) / max(abs(results["cpu"][k]), 1e-6) for k in results["cpu"]}
    # cuDNN and the CPU convolutions sum in other orders: 1e-4 relative.
    # d_ground alone gets 5e-2: RANSAC keeps the hypothesis with the most
    # points within 0.005 of its plane, and round-off in the depth moves
    # points across that line, which can change the plane it keeps.
    tol = {k: 5e-2 if k == "loss_term/d_ground" else 1e-4 for k in rel}
    worst = max(rel, key=lambda k: rel[k] / tol[k])
    print(f"fine_tune step {small.depth_model} at {small.height}x{small.width}, batch {small.batch_size}, card "
          f"(kernels) vs CPU (plain): worst relative loss difference {rel[worst]:.2e} in {worst} (tolerance "
          f"{tol[worst]:.0e}); d_ground {rel['loss_term/d_ground']:.2e}")
    if rel[worst] > tol[worst]:
        raise SystemExit(f"card step disagrees with the CPU step: {results}")
    return {"rel": rel, "launches": launches}


def checked_steps(trainer, batch, gen, smi, label):
    """STEPS training steps with the launch counts set to 0 just before and
    read just after: finite losses, moved weights and the launches per step
    that ``trainer.cfg.scales`` asks for."""
    import torch

    from dynamo_depth_torch.ops.kernels import launch_counts, reset_launch_counts

    watch = {n: p.detach().clone() for n, p in list(trainer.model.named_parameters())[::40]}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for step in range(STEPS):
        losses = trainer.train_step(batch, gen, step)
        bad = [k for k, v in losses.items() if not math.isfinite(float(v))]
        if bad:
            raise SystemExit(f"{label} step {step}: non-finite losses {bad}")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = launches_per_step(trainer.cfg)
    for k, n in counts.items():
        if n != per_step[k] * STEPS:
            raise SystemExit(f"{label}: {k} launched {n} times in {STEPS} steps, expected {per_step[k] * STEPS}")
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
    cfg = trainer.cfg
    print(f"fine_tune {label} {cfg.height}x{cfg.width} batch {cfg.batch_size} on {smi}: {STEPS} steps, losses "
          f"finite, {len(trained)} watched weights moved, peak memory {peak / 2**30:.2f} GiB; "
          f"loss {float(losses['loss']):.6f}; launches {counts}")


def capture_warp_inputs(trainer, batch, gen, step):
    """Phases 6 and 15b: one more training step, with a copy of each warp
    forward's (image, grid) kept. Returns the list of copies."""
    from dynamo_depth_torch.ops.kernels import warp

    captured = []
    launch_fwd = warp.warp_fwd

    def capture(image, gr):
        captured.append((image.detach().clone(), gr.detach().clone()))
        return launch_fwd(image, gr)

    warp.warp_fwd = capture
    try:
        trainer.train_step(batch, gen, step)
    finally:
        warp.warp_fwd = launch_fwd
    return captured


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
    checked_steps(trainer, batch, gen, smi, "monodepthv2 float32")
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


# Relative difference allowed between a loss term of the bfloat16 step and
# the float32 step from the same weights, batch and draws, for the terms
# RANSAC does not enter (found on the card: 7e-6 to 6.2e-4). d_ground and
# the totals that hold it follow RANSAC's inlier count, which bfloat16's
# rounding of the near-constant disparity of random weights changes (found:
# 0.55 on the card; up to 2.7x at 64x96 on the CPU, in the JAX package's
# bfloat16 step as in the port's): they must be finite, and are recorded.
BF16_LOSS_TOL = 1e-2
RANSAC_TERMS = {"loss", "loss_term/d_ground"} | {f"loss_term/{s}" for s in range(4)}


def run_bf16(smi):
    """Phase 10: the LiteMono fine_tune step with compute_dtype="bfloat16"
    from phase 6's seed-0 weights: its loss terms against a float32 step
    from the same weights, batch and draws; the step checked as phase 6's;
    one bfloat16 monodepthv2 step."""
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

    checked_steps(t16, batch, torch.Generator(device="cuda").manual_seed(0), smi, "LiteMono bfloat16")
    del t16, batch

    md2 = Trainer(DynamoConfig(**dict(kw, depth_model="monodepthv2", compute_dtype="bfloat16")))
    out = md2.train_step(md2.to_device(synthetic_batch(md2.cfg, B, H, W)), torch.Generator(device="cuda").manual_seed(0), 0)
    bad = [k for k, v in out.items() if not math.isfinite(float(v))]
    if bad:
        raise SystemExit(f"bfloat16 monodepthv2 step: non-finite losses {bad}")
    print(f"  one bfloat16 monodepthv2 step: loss {float(out['loss']):.6f}, every term finite")
    if rel[worst] > BF16_LOSS_TOL:
        raise SystemExit(f"bfloat16 step disagrees with the float32 step: {losses}")


DDP_TIMEOUT_S = 600  # a phase-11 launch past it is killed: a hung collective fails the script


def launch(nproc, worker, out):
    """``python -m torch.distributed.run --standalone --nproc_per_node nproc chip_smoke.py
    --ddp-worker worker out``, its output shown; raises SystemExit when it
    fails or outlasts DDP_TIMEOUT_S (then it and its ranks are stopped).
    Returns the wall seconds."""
    cmd = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           str(Path(__file__).resolve()), "--ddp-worker", worker, str(out)]
    _, _, wall = run_cli(cmd, worker, DDP_TIMEOUT_S, capture=False)
    return wall


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
    if worker == "gloo_evals":
        torch.set_num_threads(4)
        pdist.init_distributed(device="cuda:0", backend="gloo")  # NCCL refuses two ranks on one card
        (out / f"gloo_evals_rank{rank}.json").write_text(json.dumps(gloo_eval_records(rank, out)))
        torch.distributed.destroy_process_group()
        return 0
    raise SystemExit(f"unknown worker {worker}")


def gloo_main_path(rank, steps=3):
    """11b: ``steps`` fine_tune steps at 192x640, batch 3 per rank, from
    seed-0 weights, both ranks on cuda:0 over gloo: each rank's launches per
    step, and the ranks' parameters and BatchNorm buffers bit-identical
    after every step (``check_replicated`` raises if not)."""
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
    launches = []
    reset_launch_counts()
    for step in range(steps):
        before = launch_counts()
        losses = trainer.train_step(batch, trainer.generator, step)
        after = launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
        if launches[-1] != expected:
            raise SystemExit(f"rank {rank} step {step}: launches {launches[-1]}, expected {expected}")
        bad = [k for k, v in losses.items() if not math.isfinite(float(v))]
        if bad:
            raise SystemExit(f"rank {rank} step {step}: non-finite losses {bad}")
        pdist.check_replicated(trainer.model)
    trainable = sum(p.numel() for p in trainer.model.parameters() if p.requires_grad)
    bn = sum(b.numel() for n, b in trainer.model.named_buffers() if n.endswith(("running_mean", "running_var")))
    return {"launches_per_step": launches, "wrapper": type(trainer.ddp).__name__, "trainable_params": trainable,
            "bn_values": bn, "allreduce_bytes_per_step": 4 * (trainable + bn), "loss": float(losses["loss"]),
            "peak_bytes": torch.cuda.max_memory_allocated()}


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


def run_ddp(phase8_tables):
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
    print(f"  11a: trained through DistributedDataParallel over NCCL at world size 1; {wall_a:.1f} s of wall with "
          f"the launch")

    print("11b and 11c: torchrun --nproc_per_node 2, both ranks on cuda:0 over gloo:")
    wall_b = launch(2, "gloo2", out)
    ranks = [json.loads((out / f"gloo2_rank{r}.json").read_text()) for r in (0, 1)]
    mp = [r["main_path"] for r in ranks]
    for r, m in enumerate(mp):
        if m["wrapper"] != "DistributedDataParallel":
            raise SystemExit(f"11b rank {r} did not train through DDP: {m['wrapper']}")
        print(f"  rank {r}: fine_tune {H}x{W} batch {B} per rank, launches per step {m['launches_per_step'][0]}, "
              f"loss {m['loss']:.6f}, peak {m['peak_bytes'] / 2**30:.2f} GiB")
    if mp[0]["loss"] != mp[1]["loss"]:
        raise SystemExit(f"11b: the ranks' averaged losses differ: {mp[0]['loss']} vs {mp[1]['loss']}")
    print(f"  parameters and BatchNorm buffers bit-identical on both ranks after each of {len(mp[0]['launches_per_step'])} "
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


def run_vis(work):
    """12a: the entry point's curriculum with the training visualisation on,
    through a recording wandb; each log_vis call's launches; then log_vis of
    one batch on the card and on the CPU from the same weights."""
    from dynamo_depth_torch import train as train_entry
    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.data.loader import collate
    from dynamo_depth_torch.data.splits import read_split
    from dynamo_depth_torch.ops.kernels import launch_counts
    from dynamo_depth_torch.training import trainer as trainer_mod

    root = Path(__file__).resolve().parent
    argv = ["-d", "kitti", "-n", "vis", "--data_path", str(root / "assets" / "tiny_kitti") + "/", "--split",
            "tiny_kitti", "--height", str(H), "--width", str(W), "--batch_size", str(B), "--weights_init", "scratch",
            "--epoch_schedules", "1", "1", "1", "1", "--epoch-size", "1", "--log_frequency", "1",
            "--log_dir", str(work / "logs"), "--print_opt", ""]
    print(f"12a: python -m dynamo_depth_torch.train {' '.join(argv)} (wandb: a recording stand-in)")
    calls = []
    log_vis = trainer_mod.Trainer.log_vis

    def counted_log_vis(self, *args):
        before = launch_counts()
        out = log_vis(self, *args)
        after = launch_counts()
        calls.append({"phase": self.phase, "launches": {k: after[k] - before[k] for k in after}})
        return out

    stub = RecordingWandb()
    saved = sys.modules.get("wandb")
    sys.modules["wandb"] = stub
    trainer_mod.Trainer.log_vis = counted_log_vis
    try:
        trainer = train_entry.main(argv)
    finally:
        trainer_mod.Trainer.log_vis = log_vis
        if saved is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved
    cfg = trainer.cfg
    if stub.inits != [{"project": "Dynamo", "name": "vis", "notes": cfg.comment, "config": cfg.to_dict()}]:
        raise SystemExit(f"wandb.init was called with {stub.inits}")
    expected = {**dict.fromkeys(KERNEL_NAMES, 0), "warp_fwd": 2 * len(cfg.scales)}
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

    # log_vis of one batch on the card and on the CPU, from the same weights.
    cpu = trainer_mod.Trainer(DynamoConfig.from_dict(cfg.to_dict()), device="cpu", phase=trainer.phase)
    cpu.model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    ds = trainer.get_dataset(read_split(cfg.split, "train")[:B])
    batch = collate([ds.get_item(i) for i in range(B)])
    card_grids = trainer.vis_grids(trainer.to_device(batch))
    cpu_grids = cpu.vis_grids(cpu.to_device(batch))
    grids_agree(f"log_vis grids of one tiny_kitti batch ({trainer.phase}), card vs CPU", card_grids, cpu_grids, H)
    del cpu
    return work / "logs" / "vis" / "models" / "fine_tune_00"


def run_jax_folder(work, folder, phase8_table):
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
    ckpt.save_jax_folder(source.model, str(jax_folder), height=H, width=W, optimizer=source.optimizer)
    files = sorted(p.name for p in jax_folder.iterdir())
    size = sum(p.stat().st_size for p in jax_folder.iterdir())
    print(f"12b: {folder.name} with its Adam state (step {source.opt_steps}) written in the JAX package's layout: "
          f"{', '.join(files)} ({size / 2**20:.1f} MiB)")
    if any(f.endswith(".pth") for f in files) or "adam.msgpack" not in files or "meta.json" not in files:
        raise SystemExit(f"the JAX folder holds {files}")
    del source

    args = ["-d", "kitti", "--data_path", str(root / "assets" / "tiny_kitti") + "/", "--split", "tiny_kitti",
            "--height", str(H), "--width", str(W), "-b", str(B), "--num_workers", "2"]
    tables = {}
    for label, path in (("msgpack", jax_folder), ("pth", folder)):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            out = depth.main(args + ["-l", str(path), "--eval_dir", str(work / "eval_jax_folder" / label)],
                             device="cuda")
        if "FAILED" in log.getvalue() or "PARTIAL" in log.getvalue():
            raise SystemExit(f"eval.depth did not load every module of {path}:\n{log.getvalue()}")
        tables[label] = [line for line in out["lines"] if "Model Path" not in line]
    reference = [line for line in Path(phase8_table).read_text().splitlines(keepends=True) if "Model Path" not in line]
    if tables["msgpack"] != tables["pth"] or "".join(tables["pth"]).split() != "".join(reference).split():
        raise SystemExit(f"eval.depth tables differ:\n{''.join(tables['msgpack'])}\n{''.join(tables['pth'])}")
    print("  eval.depth -l <JAX folder> on the card: its table equals the .pth folder's and phase 8's")

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


# Phase 12c: update norms, card against CPU. Adam's first step moves each
# weight by about lr * sign(g), so a module's norm counts its weights; it
# moves only where the two devices' gradients differ in sign, near zeros of
# the gradient (found 2e-5 between the JAX package and the port on the CPU).
UPDATE_NORM_TOL = 1e-3


def run_grad_compare(work):
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


def run_phase12(smi, phase7, phase8_tables):
    """Phase 12: the training visualisation (12a), a JAX-layout checkpoint
    (12b), ``bench/grad_compare.py`` (12c) and ``bench/profile_top_ops.py``
    (12d) on the card."""
    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / "phase12"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    vis_folder = run_vis(work)
    run_jax_folder(work, Path(phase7["folder"]), phase8_tables["kitti"])
    run_grad_compare(work)
    run_profile_tool(smi, work, vis_folder)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")


def write_backbone_files(ckpt_dir, seed=13):
    """Random ImageNet backbone files in the layouts the pretrained init
    reads: ``resnet18-f37072fd.pth``, a torchvision ResNet-18 state dict
    (``fc.*`` included), and ``lite-mono-8m-pretrain.pth``, ``{"model": the
    Lite-Mono-8M classifier's state dict with its final ``norm.*`` and
    ``head.*``, "args": an argparse.Namespace}``. Returns the two state
    dicts."""
    import argparse

    import torch

    from dynamo_depth_torch.models.litemono import LiteMono
    from dynamo_depth_torch.models.pretrained import BACKBONE_FILES
    from dynamo_depth_torch.models.resnet import ResnetEncoder

    gen = torch.Generator().manual_seed(seed)

    def randomised(module):
        out = {}
        for k, v in module.state_dict().items():
            if k.endswith("num_batches_tracked"):
                out[k] = torch.tensor(7, dtype=torch.int64)
            elif k.endswith("running_var"):
                out[k] = torch.rand(v.shape, generator=gen) + 0.5
            else:
                out[k] = torch.randn(v.shape, generator=gen) * 0.05
        return out

    ckpt_dir.mkdir(parents=True, exist_ok=True)
    resnet = randomised(ResnetEncoder(18, 1).encoder)
    resnet.update({"fc.weight": torch.randn(1000, 512, generator=gen), "fc.bias": torch.randn(1000, generator=gen)})
    torch.save(resnet, ckpt_dir / BACKBONE_FILES["resnet18"])
    lite = randomised(LiteMono())
    lite.update({"norm.weight": torch.randn(224, generator=gen), "norm.bias": torch.randn(224, generator=gen),
                 "head.weight": torch.randn(1000, 224, generator=gen), "head.bias": torch.randn(1000, generator=gen)})
    args = argparse.Namespace(model="lite-mono-8m", drop_path=0.1, input_size=224, lr=6e-3)
    torch.save({"model": lite, "args": args}, ckpt_dir / BACKBONE_FILES["litemono"])
    return resnet, lite


def check_backbones(model, resnet, lite, seed, depth_model="litemono"):
    """Every tensor of the encoders of ``model`` (on the card) against the
    files': the ResNet trunk's, ``fc`` dropped, with conv1 widened for the
    pose (2 frames) and motion (3 frames) encoders to the file's conv1 / n
    in every 3-channel slice, and equal to ``widen_conv1`` recomputed on the
    CPU from ``RandomState(seed)`` (pose first, then motion); LiteMono's
    without the final ``norm.*``. Returns the number of tensors held."""
    import torch

    from dynamo_depth_torch.models.pretrained import widen_conv1

    rng = np.random.RandomState(seed)
    held = 0
    widths = {"pose_enc": 2, "motion_enc": 3, "depth_enc": 1}
    for module in ("pose_enc", "motion_enc", "depth_enc"):
        if module == "depth_enc" and depth_model == "litemono":
            ref = {k: v for k, v in lite.items() if not k.startswith("norm") and not k.startswith("head.")}
        else:
            ref = {f"encoder.{k}": v for k, v in resnet.items() if not k.startswith("fc.")}
        got = getattr(model, module).state_dict()
        n = widths[module]
        for key, value in ref.items():
            card = got[key].cpu()
            if key == "encoder.conv1.weight" and n > 1:
                slices = [card[:, 3 * i:3 * i + 3] for i in range(n)]
                if not all(torch.equal(sl, value / n) for sl in slices):
                    raise SystemExit(f"{module}: the widened conv1 is not the file's conv1 / {n} in each slice")
                value = widen_conv1(value, n, rng)
            if not torch.equal(card, value):
                raise SystemExit(f"{module}.{key} is not the file's tensor")
            held += 1
    return held


def run_pretrained(smi, work):
    """13a: the curriculum from the entry point at the KITTI headline config
    with the default ``weights_init`` ("pretrained") and backbone files under
    ``./ckpt``; the encoders held to the files before the first step; then
    monodepthv2 from the same folder, and a run with an empty ``ckpt/``."""
    import torch

    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.training import trainer as trainer_mod
    from dynamo_depth_torch.training.synthetic import synthetic_batch

    resnet, lite = write_backbone_files(work / "ckpt")
    loads, held = [], []
    load, train = trainer_mod.load_pretrained_backbones, trainer_mod.Trainer.train

    def counted_load(*args, **kwargs):
        loads.append(args)
        return load(*args, **kwargs)

    def checked_train(self):
        held.append(check_backbones(self.model, resnet, lite, self.cfg.seed))
        return train(self)

    cwd = os.getcwd()
    os.chdir(work)  # ./ckpt is looked up from the working directory
    trainer_mod.load_pretrained_backbones, trainer_mod.Trainer.train = counted_load, checked_train
    try:
        curriculum = run_curriculum(smi, steps=1, name="pretrained", reload=False, weights_init=None)
    finally:
        trainer_mod.load_pretrained_backbones, trainer_mod.Trainer.train = load, train
        os.chdir(cwd)
    if len(loads) != 1 or held != [held[0]] or not held[0]:
        raise SystemExit(f"13a: {len(loads)} backbone loads and {held} tensors held before the first step")
    print(f"  13a: the backbones loaded once (two files, "
          f"{sum((work / 'ckpt' / f).stat().st_size for f in os.listdir(work / 'ckpt')) / 2**20:.1f} MiB); before "
          f"the first step {held[0]} encoder tensors equal the files' (conv1 widened to the file's conv1 / 2 and / 3, "
          f"and to RandomState({DynamoConfig().seed})'s widen_conv1 on the CPU); launches per step by phase "
          + ", ".join(f"{k} {v}" for k, v in curriculum["per_step"].items()) + f", on {smi}")

    os.chdir(work)
    try:
        md2 = trainer_mod.Trainer(DynamoConfig(dataset="kitti", depth_model="monodepthv2", height=H, width=W,
                                               batch_size=B))
        n_md2 = check_backbones(md2.model, resnet, lite, md2.cfg.seed, depth_model="monodepthv2")
        del md2
        (work / "empty").mkdir()
        os.chdir(work / "empty")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cfg = DynamoConfig(dataset="kitti", height=H, width=W, batch_size=B)
            bare = trainer_mod.Trainer(cfg, phase="fine_tune")
    finally:
        os.chdir(cwd)
    print(printed.getvalue(), end="")
    messages = ["|- pretrained resnet weights not found under ./ckpt - encoders keep random init",
                "|- ./ckpt/lite-mono-8m-pretrain.pth not found - litemono depth encoder keeps random init"]
    if [line for line in printed.getvalue().splitlines() if "random init" in line] != messages:
        raise SystemExit(f"13a: with an empty ckpt/ the trainer printed {printed.getvalue()!r}")
    batch = bare.to_device(synthetic_batch(cfg, B, H, W))
    losses = bare.train_step(batch, torch.Generator(device=bare.device).manual_seed(0), 0)
    if not all(math.isfinite(float(v)) for v in losses.values()):
        raise SystemExit(f"13a: the fine_tune step from random init gave {losses}")
    print(f"  13a: monodepthv2 from the same ckpt/: {n_md2} encoder tensors equal the files'; with an empty ckpt/ "
          f"the JAX package's two messages, and a fine_tune step from random init, loss {float(losses['loss']):.5f}")
    del bare
    torch.cuda.empty_cache()


def run_zoo(smi, work, folder, phase8_table):
    """13b: ``eval.depth -l ckpt/K_Dynamo-Depth`` through a stub ``gdown`` on
    ``PATH`` that zips the module files of ``folder``, as a released folder
    holds them: its table equals phase 8's of ``folder``; then with no
    ``gdown`` on ``PATH``, the FileNotFoundError naming the id."""
    from dynamo_depth_torch.eval import depth
    from dynamo_depth_torch.models.model import MODULE_NAMES
    from dynamo_depth_torch.models.pretrained import MODEL_ZOO

    name = "ckpt/K_Dynamo-Depth"
    modules = sorted(f"{m}.pth" for m in MODULE_NAMES)
    stub_dir = work / "bin"
    stub_dir.mkdir(parents=True)
    stub = stub_dir / "gdown"
    stub.write_text(f"#!{sys.executable}\n"
                    "import pathlib, sys, zipfile\n"
                    f"folder = pathlib.Path({str(folder)!r})\n"
                    "with zipfile.ZipFile('K_Dynamo-Depth.zip', 'w') as z:\n"
                    f"    for f in {modules!r}:\n"
                    "        z.write(folder / f, 'K_Dynamo-Depth/' + f)\n"
                    "open('gdown_args.txt', 'w').write(' '.join(sys.argv[1:]))\n")
    stub.chmod(0o755)
    argv = ["-d", "kitti", "--data_path", f"{Path(__file__).resolve().parent / 'assets' / 'tiny_kitti'}/", "--split",
            "tiny_kitti", "-l", name, "--height", str(H), "--width", str(W), "-b", str(B), "--num_workers", "2",
            "--eval_dir", str(work / "eval")]
    cwd, path = os.getcwd(), os.environ["PATH"]
    for leg in ("stub", "none"):
        (work / leg).mkdir()
        os.chdir(work / leg)
        os.environ["PATH"] = str(stub_dir) + os.pathsep + path if leg == "stub" else str(work / "empty_bin")
        try:
            if leg == "stub":
                t0 = time.perf_counter()
                table = depth.main(argv)["path"]
                seconds = time.perf_counter() - t0
                fetched = sorted(p.name for p in (work / leg / name).iterdir())
                gdown_args = (work / leg / "gdown_args.txt").read_text()
            else:
                try:
                    depth.main(argv)
                    raise SystemExit("13b: with no gdown on PATH eval.depth -l ckpt/K_Dynamo-Depth raised nothing")
                except FileNotFoundError as e:
                    error = str(e)
        finally:
            os.chdir(cwd)
            os.environ["PATH"] = path
    if gdown_args != MODEL_ZOO[name] or fetched != modules:
        raise SystemExit(f"13b: gdown was called with {gdown_args!r} and fetched {fetched}")
    got, ref = Path(table).read_text().splitlines(), Path(phase8_table).read_text().splitlines()
    model_line = [i for i, line in enumerate(ref) if line.startswith("====== Model Path")]
    if len(got) != len(ref) or any(a != b for i, (a, b) in enumerate(zip(got, ref)) if i not in model_line):
        raise SystemExit(f"13b: the table of {name} differs from phase 8's:\n" + "\n".join(got))
    if MODEL_ZOO[name] not in error or name not in error:
        raise SystemExit(f"13b: the error does not name the id and the folder: {error}")
    print(f"  13b: eval.depth -l {name} through a stub gdown ({gdown_args}): {len(fetched)} files unzipped into "
          f"{name}, its table equal to phase 8's (all lines but the model path), {seconds:.1f} s on {smi}; with no "
          f"gdown on PATH: FileNotFoundError({error[:90]}...)")


def gloo_eval_records(rank, out):
    """13c: eval.motion_segmentation on tiny_waymo and eval.odometry on the
    8-frame segment from phase 7's fine_tune_00, with the two ranks on the
    card, as phase 8 ran them on one process; each rank under its own eval
    folder."""
    from dynamo_depth_torch.eval import motion_segmentation, odometry

    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke"
    folder = work / "logs" / "curriculum" / "models" / "fine_tune_00"

    def argv(data, split):
        return ["-d", "waymo", "--data_path", f"{data}/", "--split", split, "-l", str(folder), "--height", str(H),
                "--width", str(W), "-b", str(B), "--num_workers", "2", "--eval_dir", str(out / f"eval13_rank{rank}")]

    mot = motion_segmentation.main(argv(root / "assets" / "tiny_waymo", "tiny_waymo"), device="cuda:0")
    odom = odometry.main(argv(work / "data", "odom"), device="cuda:0")
    return {"mot_seg": {"npz": mot["npz"], "fp_tally": {str(k): int(v) for k, v in mot["fp_tally"].items()},
                        **{k: mot[k].tolist() for k in ("tp", "fp", "fn")}},
            "odometry": {"npy": odom["npy"], "txt": odom["txt"]}}


def run_gloo_evals(smi, phase8):
    """13c: the two CLIs on two gloo ranks sharing the card, against phase
    8's one-process records within phase 8's tolerances."""
    out = Path(__file__).resolve().parent / "build" / "chip_smoke" / "phase13_gloo"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    wall = launch(2, "gloo_evals", out)
    ranks = [json.loads((out / f"gloo_evals_rank{r}.json").read_text()) for r in (0, 1)]
    one, two = phase8["mot_seg"], ranks[0]["mot_seg"]
    pixels = 1280 * 1920  # the one non-edge frame at Waymo's full resolution
    if one["fp_tally"].keys() != two["fp_tally"].keys() or any(ranks[1]["mot_seg"][k] != two[k] for k in
                                                              ("tp", "fp", "fn", "fp_tally")):
        raise SystemExit(f"13c: FP tally categories {two['fp_tally']} vs {one['fp_tally']}, "
                         "or the ranks' counts differ")
    sides = "2 ranks vs phase 8's one process"
    agree("13c mot_seg tp/fp/fn (fraction of the pixels)",
          max(float(np.abs(np.subtract(one[k], two[k])).max()) for k in ("tp", "fp", "fn")) / pixels, 1e-3, sides)
    agree("13c mot_seg FP tally (fraction of the pixels)",
          max(abs(one["fp_tally"][k] - two["fp_tally"][k]) for k in one["fp_tally"]) / pixels, 1e-3, sides)
    a, b = np.load(phase8["odometry_npy"]), np.load(ranks[0]["odometry"]["npy"])
    if a.shape != b.shape or a.size == 0:
        raise SystemExit(f"13c: odometry records of shape {a.shape} and {b.shape}")
    agree(f"13c odometry ATE and speed ({a.shape[0]} tracks; relative)", float((np.abs(a - b) / np.abs(a)).max()),
          1e-4, sides)
    written = [p for p in (ranks[1]["mot_seg"]["npz"], ranks[1]["odometry"]["npy"], ranks[1]["odometry"]["txt"])
               if Path(p).exists()]
    if written or not Path(two["npz"]).exists():
        raise SystemExit(f"13c: rank 1 wrote {written}, or rank 0 wrote no npz")
    print(f"  13c: rank 0 alone wrote the records; {wall:.1f} s of wall with the launch, on {smi}")


def run_phase13(smi, phase7, phase8):
    """Phase 13: the pretrained init (13a), a zoo name (13b) and the
    motion-segmentation and odometry CLIs on two ranks (13c)."""
    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / "phase13"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    run_pretrained(smi, work)
    run_zoo(smi, work / "zoo", Path(phase7["folder"]), phase8["tables"]["kitti"])
    run_gloo_evals(smi, phase8)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")


BENCH_TIMEOUT_S = 600  # a phase-14 command past it is killed (the CLI's own budget is 540 s)
ENTRY_RTOL = 1e-4  # 14b: entry()'s outputs, card against CPU, relative to each output's largest value


def run_cli(args, label, timeout=BENCH_TIMEOUT_S, capture=True):
    """``python <args>``, bounded by ``timeout`` seconds
    (``dynamo_depth_torch/utils/bounded.py``: past it the command and every
    process it started are stopped); raises SystemExit when it fails or
    times out. Returns (stdout, stderr, wall seconds); with ``capture``
    False the output is shown instead and both are None."""
    from dynamo_depth_torch.utils import bounded

    print(f"  {label}: python {' '.join(args)}", flush=True)
    pipes = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) if capture else {}
    t0 = time.perf_counter()
    try:
        proc = bounded.run([sys.executable, *args], timeout, cwd=str(Path(__file__).resolve().parent), **pipes)
    except subprocess.TimeoutExpired:
        raise SystemExit(f"{label}: still running after {timeout} s, stopped")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        shown = f"\nstdout:\n{proc.stdout[-4000:]}\nstderr:\n{proc.stderr[-4000:]}" if capture else ""
        raise SystemExit(f"{label}: exit code {proc.returncode}{shown}")
    return proc.stdout, proc.stderr, wall


def run_bench_cli(smi, argv, batches, dtype):
    """14a: ``python -m dynamo_depth_torch.bench.throughput`` as a user runs
    it: the last stdout line is the contract, with a finite value > 0 for
    the best of ``batches``; every leg completed and launched each kernel
    6 times per step, the warp's instances those of the operand dtype the
    leg's batch picks under ``--image_dtype auto`` (bfloat16 at b8, float32
    at b3 and b7)."""
    from dynamo_depth_torch.config import DynamoConfig

    out, err, wall = run_cli(["-m", "dynamo_depth_torch.bench.throughput", *argv], f"14a throughput {dtype}")
    for line in err.splitlines():
        if line.startswith("[bench]") and "leg result:" not in line:
            print(f"    {line}")
    contract = json.loads(out.strip().splitlines()[-1])
    legs = [json.loads(line.split("leg result:", 1)[1]) for line in err.splitlines()
            if line.startswith("[bench] leg result:")]
    value = contract.get("value")
    if (not isinstance(value, (int, float)) or not math.isfinite(value) or value <= 0 or contract["unit"] != "examples/s"
            or not re.fullmatch(rf"kitti_litemono_fine_tune_train_throughput_{dtype}_b\d+", contract["metric"])):
        raise SystemExit(f"14a: contract {contract}")
    if [leg["batch_size"] for leg in legs] != batches:
        raise SystemExit(f"14a: legs completed at batch {[leg['batch_size'] for leg in legs]}, expected {batches}")
    for leg in legs:
        expected = launches_per_step(DynamoConfig(dataset="kitti", batch_size=leg["batch_size"]))
        operand = "bfloat16" if expected["warp_fwd_bf16"] else "float32"
        if leg["launches_per_step"] != expected or leg["warp_operand_dtype"] != operand:
            raise SystemExit(f"14a: b{leg['batch_size']} launched {leg['launches_per_step']} per step with "
                             f"{leg['warp_operand_dtype']} warp operands, expected {expected} with {operand}")
        print(f"    {dtype} b{leg['batch_size']}: {leg['examples_per_sec']:.2f} examples/s, {leg['ms_per_step']:.2f} "
              f"ms/step, {leg['flops_per_step']:.4e} FLOP/step (FlopCounterMode), MFU {100 * leg['mfu']:.3f}% of "
              f"the {dtype} peak; {operand} warp operands, launches per step {leg['launches_per_step']}, on {smi}")
    print(f"    contract: {json.dumps(contract)} ({wall:.1f} s of wall)")


def run_entry(smi):
    """14b: ``entry()`` on the card against ``entry(device="cpu")`` with the
    card's weights: the three outputs within ENTRY_RTOL, no kernel
    launched."""
    import torch

    from dynamo_depth_torch.entry import ENTRY_OUTPUTS, entry
    from dynamo_depth_torch.ops.kernels import launch_counts, reset_launch_counts

    fn, (model, batch) = entry()
    fn_cpu, (model_cpu, batch_cpu) = entry(device="cpu")
    model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    reset_launch_counts()
    card = fn(model, batch)
    launches = launch_counts()
    if any(launches.values()):
        raise SystemExit(f"14b: entry()'s forward launched {launches}")
    cpu = fn_cpu(model_cpu, batch_cpu)
    for key, a, b in zip(ENTRY_OUTPUTS, card, cpu):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise SystemExit(f"14b: {key} of shape {tuple(a.shape)} vs {tuple(b.shape)}, or not finite")
        agree(f"14b entry() {key} {tuple(a.shape)} (relative to its largest value)",
              max_err(a.cpu(), b) / max(float(b.abs().max()), 1e-30), ENTRY_RTOL)
    print(f"  14b entry(): LiteMono forward with flow and mask at {H}x{W}, batch 1, on {smi}")


def run_dryruns(smi):
    """14c: ``python -m dynamo_depth_torch.entry 1`` (NCCL) and ``... 2
    --backend=gloo`` (two ranks sharing the card): both arms completed, each
    arm's loss finite; the arms' wall seconds."""
    for label, argv in (("nccl1", ["1"]), ("gloo2", ["2", "--backend=gloo"])):
        out, _, wall = run_cli(["-m", "dynamo_depth_torch.entry", *argv], f"14c dryrun {label}")
        n = argv[0]
        losses = re.findall(rf"dryrun_multichip\({n}\) \[([^\]]+)\]: fine_tune step OK, loss=(\S+)", out)
        arms = dict(re.findall(r"dryrun_multichip: (\S+) arm took (\S+) s of wall", out))
        if "dryrun_multichip: both arms completed" not in out or len(losses) != 2 or \
                not all(math.isfinite(float(v)) for _, v in losses):
            raise SystemExit(f"14c {label}: not both arms completed with finite losses:\n{out[-4000:]}")
        print(f"    {label}: " + "; ".join(f"{tag} loss {v}" for tag, v in losses) + "; arms "
              + ", ".join(f"{k} {v} s" for k, v in arms.items()) + f"; {wall:.1f} s of wall with the launch, on {smi}")


def run_phase14(smi):
    """Phase 14: the throughput CLI (14a), ``entry()`` (14b) and the dry
    run (14c)."""
    t0 = time.perf_counter()
    run_bench_cli(smi, [], [7, 8, 3], "bfloat16")
    run_bench_cli(smi, ["--compute_dtype", "float32", "--batch_size", "3"], [3], "float32")
    run_entry(smi)
    run_dryruns(smi)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")


B15 = 8  # phase 15: the throughput CLI's b8 leg, 983,040 px: bfloat16 warp operands under auto


def warp_vs_plain_bf16(img, grids, g_warp):
    """15a: K1/K2's bfloat16 instances against the plain version on the same
    bfloat16 image (widened to float32) on each of ``grids`` ({label: grid}):
    the output, d_grid (K2 with and without d_image) and d_image; and the
    output and d_grid bit-equal to the float32 instances' on the rounded
    image."""
    import torch

    from dynamo_depth_torch.ops.kernels import warp

    img32 = img.float()
    for label, gr in grids.items():
        out_k = warp.warp_fwd(img, gr)
        d_img_k, d_grid_k = warp.warp_bwd(img, gr, g_warp, True)
        _, d_grid_k2 = warp.warp_bwd(img, gr, g_warp, False)
        img_r, grid_r = img.clone().requires_grad_(), gr.clone().requires_grad_()
        out_p = warp.grid_sample_plain(img_r, grid_r)
        d_img_p, d_grid_p = torch.autograd.grad(out_p, (img_r, grid_r), g_warp)
        out_32 = warp.warp_fwd(img32, gr)
        _, d_grid_32 = warp.warp_bwd(img32, gr, g_warp, False)
        torch.cuda.synchronize()
        # The float32 instances' arithmetic after the taps: the same
        # tolerances as theirs (phase 3).
        check(f"warp_fwd_bf16 vs plain ({label})", max_err(out_k, out_p), 1e-5)
        err = max(max_err(d_grid_k, d_grid_p), max_err(d_grid_k2, d_grid_p))
        check(f"warp_bwd_bf16 d_grid vs plain ({label}, |d_grid| up to {float(d_grid_p.abs().max()):.1f})", err,
              1e-5 * max(1.0, float(d_grid_p.abs().max())))
        # d_image: float32 sums in no fixed order, each rounded once to
        # bfloat16: one bfloat16 step (2^-7 relative) apart at most.
        check(f"warp_bwd_bf16 d_image vs plain ({label})", max_err(d_img_k.float(), d_img_p.float()),
              2**-7 * max(1.0, float(d_img_p.float().abs().max())))
        # The same float32 arithmetic after the taps as the float32
        # instances': bit-equal to theirs on the rounded image.
        if not (torch.equal(out_k, out_32) and torch.equal(d_grid_k2, d_grid_32)):
            raise SystemExit(f"15a ({label}): the bfloat16 instances are not bit-equal to the float32 ones on the "
                             f"rounded image: output {max_err(out_k, out_32):.3e}, d_grid "
                             f"{max_err(d_grid_k2, d_grid_32):.3e}")
        print(f"    ({label}) bit-equal to the float32 instances on the rounded image")


def run_phase15(smi):
    """Phase 15: K1/K2's bfloat16-image instances at the b8 step's shapes
    (8 x 3 x 192 x 640, ``--image_dtype auto``). (b) The LiteMono fine_tune
    step at batch 8, float32 networks: STEPS steps with the launch counts
    set to 0 just before and read just after (6 of each bfloat16 instance
    per step, none of the float32 warp instances), and one more whose six
    warp inputs are captured; (a) the instances against the plain version
    on a uniform grid, the ego-motion grid, a grid at the clamp's ties and
    the six step grids, and bit-equal to the float32 instances on the
    rounded image; (b) one step on the card against the CPU from the same
    weights, phase 5's tolerances."""
    import torch

    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.training.synthetic import ego_motion_grid, synthetic_batch
    from dynamo_depth_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = DynamoConfig(dataset="kitti", depth_model="litemono", batch_size=B15, weights_init="scratch")
    per_step = launches_per_step(cfg)
    if not (per_step["warp_fwd_bf16"] == per_step["warp_bwd_bf16"] == 6 and per_step["warp_fwd"] == 0):
        raise SystemExit(f"phase 15: batch {B15} at {H}x{W} under auto should warp bfloat16 images: {per_step}")

    # ---- 15b: the b8 step (the bfloat16 instances' main path) --------------
    trainer = Trainer(cfg)
    batch = trainer.to_device(synthetic_batch(cfg, B15, H, W))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    checked_steps(trainer, batch, gen, smi, "LiteMono float32, bfloat16 warp operands")
    captured = capture_warp_inputs(trainer, batch, gen, STEPS)
    if len(captured) != 6 or any(im.dtype != torch.bfloat16 or im.shape != (B15, C, H, W) for im, _ in captured):
        raise SystemExit(f"15b: captured {[(im.dtype, tuple(im.shape)) for im, _ in captured]}, expected 6 bfloat16 "
                         f"images of {(B15, C, H, W)}")
    del trainer, batch
    torch.cuda.empty_cache()

    # ---- 15a: the instances against the plain version ----------------------
    g = torch.Generator(device=dev).manual_seed(15)
    img = torch.rand(B15, C, H, W, device=dev, generator=g).bfloat16()
    uniform = torch.rand(B15, H, W, 2, device=dev, generator=g) * 2.2 - 1.1
    g_warp = torch.randn(B15, C, H, W, device=dev, generator=g)
    grids = {"uniform grid": uniform, "ego-motion grid": ego_motion_grid(B15, H, W, seed=0).to(dev),
             f"grid with {int((uniform.clamp(-1, 1).abs() == 1).sum())} entries at the clamp's ties":
                 uniform.clamp(-1.0, 1.0)}
    print(f"15a: the bfloat16 instances vs plain at B={B15} C={C} {H}x{W}, the image rounded to bfloat16:")
    warp_vs_plain_bf16(img, grids, g_warp)
    step_img = captured[0][0]
    if any(not torch.equal(im, step_img) for im, _ in captured[::2]) or not all(
            bool(torch.isfinite(gr).all()) for _, gr in captured):
        raise SystemExit("15a: the step's warp inputs are not one image per source frame with finite grids")
    warp_vs_plain_bf16(step_img.contiguous(), {f"step grid {i}": gr for i, (_, gr) in enumerate(captured)}, g_warp)

    # ---- 15b: the b8 step on the card against the CPU ----------------------
    cmp = card_vs_cpu_step(cfg)
    if cmp["launches"] != per_step:
        raise SystemExit(f"15b: the card's step launched {cmp['launches']}, expected {per_step}")
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.ops.kernels import build, photometric, warp
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

    def scale_tol(ref, rel=1e-5):
        return rel * max(1.0, float(ref.abs().max()))

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
        check(f"warp_fwd vs plain ({label})", max_err(out_k, out_p), 1e-5)
        check(f"warp_fwd vs F.grid_sample ({label})", max_err(out_k, out_l), 1e-5)
        # d_grid is a 3-term sum scaled by (W-1)/2 = 319.5: 1e-5 of its scale.
        check(f"warp_bwd d_grid vs plain ({label})", max(max_err(d_grid_k, d_grid_p), max_err(d_grid_k2, d_grid_p)),
              scale_tol(d_grid_p))
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
    check("photometric_fwd vs plain", max_err(out_k, out_p), 1e-5)
    check("photometric_bwd d_pred vs plain", max(max_err(d_pred_k, d_pred_p), max_err(d_pred_k2, d_pred_p)),
          scale_tol(d_pred_p, 1e-4))
    check("photometric_bwd d_target vs plain", max_err(d_target_k, d_target_p), scale_tol(d_target_p, 1e-4))

    # ---- 4. the kernels at exact ties --------------------------------------
    # K4 where pred equals target: jnp.abs's subgradient 1 at 0 gives the L1
    # term -(1 - w) / C * g in d_pred, where the SSIM term vanishes. K2 where
    # the grid lies exactly on the border: jnp.clip passes half the
    # coordinate gradient there.
    pred_r, target_r = pred.clone().requires_grad_(), pred.clone().requires_grad_()
    out_p = photometric.reprojection_loss_plain(pred_r, target_r, 0.85)
    d_pred_p, d_target_p = torch.autograd.grad(out_p, (pred_r, target_r), g_photo)
    d_pred_k, d_target_k = photometric.photometric_bwd(pred, pred, g_photo, 0.85, True)
    torch.cuda.synchronize()
    check(f"photometric_bwd where pred == target (|d_pred| up to {float(d_pred_p.abs().max()):.3f})",
          max(max_err(d_pred_k, d_pred_p), max_err(d_target_k, d_target_p)), scale_tol(d_pred_p, 1e-4))
    on_border = grid.clamp(-1.0, 1.0)
    img_r, grid_r = img.clone().requires_grad_(), on_border.clone().requires_grad_()
    out_p = warp.grid_sample_plain(img_r, grid_r)
    d_img_p, d_grid_p = torch.autograd.grad(out_p, (img_r, grid_r), g_warp)
    d_img_k, d_grid_k = warp.warp_bwd(img, on_border, g_warp, True)
    torch.cuda.synchronize()
    ties = int((on_border.abs() == 1.0).sum())
    check(f"warp_bwd d_grid on a grid with {ties} entries of exactly -1 or 1", max_err(d_grid_k, d_grid_p),
          scale_tol(d_grid_p))
    check("warp_bwd d_image on that grid", max_err(d_img_k, d_img_p), scale_tol(d_img_p))

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
    checked_steps(trainer, batch, gen, smi, "LiteMono float32")

    # the warp's inputs in the step (one extra step, captured)
    captured = capture_warp_inputs(trainer, batch, gen, STEPS)
    if len(captured) != 6 or any(im.shape != img.shape or gr.shape != grid.shape for im, gr in captured):
        raise SystemExit(f"captured {len(captured)} warp inputs of the step, expected 6 of {tuple(img.shape)}")
    for i, (_, gr) in enumerate(captured):
        if not bool(torch.isfinite(gr).all()):
            raise SystemExit(f"step grid {i} is not finite")
    print(f"  the step's warp inputs: {len(captured)} images of {tuple(img.shape)}, every grid finite")
    del captured, trainer, batch

    # ---- 7. the curriculum from the port's entry point, on tiny_kitti -----
    phase7 = run_curriculum(smi)

    # ---- 8. the eval path from phase 7's last checkpoint -------------------
    print(f"eval path: the four eval CLIs and the quick demo from {phase7['folder']}, on the card and on the CPU:")
    phase8 = run_eval(smi, phase7["folder"], phase7["work"])

    # ---- 9. monodepthv2: the step, the curriculum and depth eval ----------
    run_monodepthv2(smi, phase7["work"])

    # ---- 10. bfloat16: the LiteMono step against float32 -------------------
    run_bf16(smi)

    # ---- 11. data parallelism: torchrun, NCCL at world size 1, two gloo ranks
    print("data parallelism (phase 11):")
    run_ddp(phase8["tables"])

    # ---- 12. the training visualisation, JAX folders and the bench tools ---
    print("phase 12:")
    run_phase12(smi, phase7, phase8["tables"])

    # ---- 13. the pretrained init, a zoo name, two-rank motion and odometry eval
    print("phase 13:")
    run_phase13(smi, phase7, phase8)

    # ---- 14. the throughput CLI, entry() and the dry run --------------------
    print("phase 14:")
    torch.cuda.empty_cache()  # the legs and ranks are processes of their own
    run_phase14(smi)

    # ---- 15. K1/K2's bfloat16-image instances at batch 8 -------------------
    print("phase 15:")
    torch.cuda.empty_cache()
    run_phase15(smi)

    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--ddp-worker":  # a rank of a phase-11 launch
        sys.exit(ddp_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
