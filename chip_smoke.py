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
   6's numbers; one bfloat16 monodepthv2 step with finite losses.

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


def run_curriculum(smi, depth_model="litemono", steps=3, name="curriculum"):
    """Phases 7 and 9: the curriculum from the entry point, ``steps`` steps
    per phase. Returns {"launches": {kernel: n}, "per_step": {kernel:
    {phase: n}}, "summary": {...}}; raises SystemExit on any failure."""
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
                                  "losses": {k: float(v) for k, v in losses.items()}})
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

    last = models / "fine_tune_00"
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
    return {"launches": launches, "per_step": per_step, "summary": summary, "folder": last, "work": work}


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
    # Every watched weight that receives a gradient has moved (the dilated
    # blocks' unused LayerNorm receives none).
    trained = [(n, p) for n, p in trainer.model.named_parameters() if n in watch and p.grad is not None]
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
            "ms_cold": cold[(k, "uniform" if warp_k else None)][0],
            "library_ms_cold": cold[(k, "uniform" if warp_k else None)][1],
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
                            "peak_bytes": phase10["step"]["peak_bytes"], "loss_rel_err": phase10["rel"]}}
    print(json.dumps({"kernels": kernels, "step_ms": ms, "examples_per_s": B / ms * 1e3,
                      "peak_bytes": peak, "curriculum": phase7["summary"], "eval": phase8, "steps": summary,
                      "card": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
