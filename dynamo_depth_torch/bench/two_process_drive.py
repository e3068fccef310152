"""Two-process drive of the port's data parallelism on the CPU, over gloo.

    python -m dynamo_depth_torch.bench.two_process_drive --out build/two_proc [--epoch_schedules 1 1 1 1]

The counterpart of the JAX package's ``scripts/two_process_drive.py``. It
runs the port's entry points in two topologies on ``assets/tiny_kitti``:

  single: 1 process, batch 2
  multi:  2 processes of batch 1 each, launched by torchrun

Training goes through ``dynamo_depth_torch.train.main`` (the curriculum of
``--epoch_schedules``, by default ``disp_init`` alone; ``STEPS`` steps per
phase, 32x64), with one validation
batch scored on the initial weights before it; evaluation of the single
run's last folder through ``dynamo_depth_torch.eval.depth.main`` on
``tiny_kitti`` (Part 1) and ``tiny_waymo`` (Parts 1 and 2), through
``eval.motion_segmentation.main`` on ``tiny_waymo`` and through
``eval.odometry.main`` on an 8-frame segment made from the Waymo fixture
(:func:`build_odometry_segment`), at a global batch of 2. Each rank writes
under its own log and eval folders, so that what rank 1 writes shows. Checks:

- the validation depth metrics of the initial weights agree to ``RTOL``
  (the same rows, reduced in another order) on both ranks;
- both ranks hold bit-identical parameters and buffers after training
  (their ``state_fingerprint``);
- rank 0 alone wrote the checkpoint folders and the eval records;
- the eval tables of the two topologies are equal; the motion-segmentation
  counts and false-positive tally agree to ``COUNT_TOL`` of the pixels, its
  precision, recall and f1 to ``COUNT_TOL``; the odometry records to
  ``ODOM_RTOL``.

Training losses are not compared across topologies: each rank normalises
with its own rows' BatchNorm statistics, so batch 2 on one process and
batch 1 on each of two are different programs. Prints one line per check
and ``ALL PASS``; exits non-zero otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
ASSETS = ROOT / "assets"
KITTI_SEQ = "2011_09_26/2011_09_26_drive_0001_sync"
WAYMO_SEG = "val/segment-0000000000_tiny_fixture"
RTOL = 2e-4  # the JAX drive's: float32 sums of the same rows in another order
# The eval CLIs' own tolerances between two runs of one checkpoint: a mask
# value near a threshold moves pixels across it with round-off; poses and
# ATE to float32's round-off.
COUNT_TOL, ODOM_RTOL = 1e-3, 1e-4
WAYMO_PIXELS = 1280 * 1920  # one frame at Waymo's full resolution
ODOM_SEG, ODOM_FRAMES = "val/segment-0000000001_eight_frames", 8
PHASE_FOLDERS = ("disp_init_00", "motion_init_00", "mask_init_00", "fine_tune_00")
EVAL_DATASETS = ("kitti", "waymo")
TIMEOUT_S = 900  # a worker past it is killed: a hung collective fails the drive
H, W, STEPS = 32, 64, 2


# --------------------------------------------------------------- worker side

def _rank() -> int:
    return int(os.environ.get("RANK", 0))


def run_train(args) -> None:
    """Train through the entry point, validating the initial weights first;
    write this rank's history and final state."""
    import torch

    from dynamo_depth_torch import train as train_entry
    from dynamo_depth_torch.parallel import state_fingerprint
    from dynamo_depth_torch.training.trainer import Trainer

    torch.set_num_threads(1)
    train = Trainer.train

    def validate_then_train(self):
        self.step, self._val_iter = 0, None
        self.val()
        return train(self)

    Trainer.train = validate_then_train
    out = Path(args.out)
    argv = [
        "-d", "kitti", "-n", "drive", "--data_path", f"{ASSETS / 'tiny_kitti'}/", "--split", "tiny",
        "--height", str(H), "--width", str(W), "-b", str(args.batch), "--weights_init", "scratch",
        "--epoch_schedules", *map(str, args.epoch_schedules), "--epoch-size", str(STEPS),
        "--log_frequency", "1", "--num_workers", "1", "--print_opt", "", "--no_train_vis",
        "--log_dir", str(out / f"{args.name}_rank{_rank()}" / "logs"),
    ]
    trainer = train_entry.main(argv, device="cpu")
    (out / f"{args.name}_rank{_rank()}.json").write_text(json.dumps(
        {"history": trainer.history, "world": trainer.world, "ddp": type(trainer.ddp).__name__,
         "fingerprint": state_fingerprint(trainer.model).tolist()}))


def run_eval(args) -> None:
    """``eval.depth`` of ``args.ckpt`` on each of :data:`EVAL_DATASETS`,
    ``eval.motion_segmentation`` on tiny_waymo and ``eval.odometry`` on the
    8-frame segment; writes what the last two return on this rank."""
    import torch

    from dynamo_depth_torch.eval import depth, motion_segmentation, odometry

    torch.set_num_threads(1)
    out = Path(args.out)

    def argv(dataset, data, split):
        return ["-d", dataset, "--data_path", f"{data}/", "--split", split, "-l", args.ckpt, "--height", str(H),
                "--width", str(W), "-b", "2", "--num_workers", "1",
                "--eval_dir", str(out / f"eval_{args.name}_rank{_rank()}")]

    for dataset in EVAL_DATASETS:
        depth.main(argv(dataset, ASSETS / f"tiny_{dataset}", f"tiny_{dataset}"), device="cpu")
    mot = motion_segmentation.main(argv("waymo", ASSETS / "tiny_waymo", "tiny_waymo"), device="cpu")
    odom = odometry.main(argv("waymo", out / "data", "odom"), device="cpu")
    (out / f"eval_{args.name}_rank{_rank()}.json").write_text(json.dumps({
        "mot_seg": {"npz": mot["npz"], "fp_tally": {str(k): v for k, v in mot["fp_tally"].items()},
                    **{k: mot[k].tolist() for k in ("tp", "fp", "fn")}},
        "odometry": {"npy": odom["npy"], "txt": odom["txt"]}}))


def build_odometry_segment(data_root: Path) -> Path:
    """An 8-frame Waymo segment under ``data_root``: the vendored fixture's
    3 images cycled, its intrinsics, and 8 ground-truth poses from a seeded
    random drive (the fixture's own 3 frames leave one frame away from the
    edges and no 5-frame track)."""
    src = ASSETS / "tiny_waymo" / WAYMO_SEG / "FRONT" / "rgb"
    dst = Path(data_root) / ODOM_SEG / "FRONT"
    shutil.rmtree(dst, ignore_errors=True)
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
    return Path(data_root)


# ----------------------------------------------------------- orchestrator

def write_splits(root: Path) -> Path:
    """Training and validation on tiny_kitti's frames 0 and 1 (both cameras);
    eval on its three left frames, tiny_waymo's three frames and the 8-frame
    odometry segment."""
    splits = {
        "tiny": {w: [f"{KITTI_SEQ} {i} {s}" for i in (0, 1) for s in "lr"] for w in ("train", "val")},
        "tiny_kitti": {"test": [f"{KITTI_SEQ} {i} l" for i in range(3)]},
        "tiny_waymo": {w: [f"{WAYMO_SEG} {i}" for i in range(3)] for w in ("test", "test_mask")},
        "odom": {"test": [f"{ODOM_SEG} {i}" for i in range(ODOM_FRAMES)]},
    }
    for name, files in splits.items():
        (root / name).mkdir(parents=True, exist_ok=True)
        for which, lines in files.items():
            (root / name / f"{which}_files.txt").write_text("".join(line + "\n" for line in lines))
    return root


def _launch(args, worker: str, name: str, nproc: int, extra=()) -> subprocess.Popen:
    """The worker as one plain process, or as ``nproc`` under torchrun."""
    module = ["-m", "dynamo_depth_torch.bench.two_process_drive", "--worker", worker, "--name", name,
              "--out", args.out, *extra]
    if nproc > 1:
        # --standalone: torchrun binds its rendezvous store to a port the
        # system picks and keeps it (no port found free and handed on).
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
               *module]
    else:
        cmd = [sys.executable, *module]
    env = dict(os.environ, DYNAMO_SPLITS_DIR=str(Path(args.out) / "splits"), OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    log = open(Path(args.out) / f"{worker}_{name}.log", "w")
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc


def _run_both(args, worker: str, extra_single=(), extra_multi=(), extra=()) -> None:
    """The single and the multi topology of ``worker`` at once; raises
    SystemExit naming the log of a leg that failed."""
    procs = {"single": _launch(args, worker, "single", 1, [*extra, *extra_single]),
             "multi": _launch(args, worker, "multi", 2, [*extra, *extra_multi])}
    failed = []
    for name, proc in procs.items():
        try:
            rc = proc.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        if rc != 0:
            failed.append(f"{worker} {name}: rc={rc}, log {Path(args.out) / f'{worker}_{name}.log'}")
    if failed:
        for line in failed:
            print(line)
        tail = (Path(args.out) / f"{worker}_{failed[0].split()[1].rstrip(':')}.log").read_text().splitlines()[-30:]
        raise SystemExit("a leg failed:\n" + "\n".join(tail))


def _report(ok: bool, what: str, detail: str = "") -> bool:
    print(f"{'PASS' if ok else 'FAIL'}  {what}{': ' + detail if detail else ''}", flush=True)
    return ok


def table_path(out: Path, name: str, rank: int, dataset: str, ckpt: Path) -> Path:
    """Where ``eval.depth`` of ``ckpt`` writes its table for that leg."""
    from dynamo_depth_torch.utils.io import get_model_ckpt_name

    model_name, ckpt_name = get_model_ckpt_name(str(ckpt))
    return out / f"eval_{name}_rank{rank}" / f"{model_name}_{dataset}" / "depth" / f"{ckpt_name}.txt"


def compare_eval_records(out: Path) -> bool:
    """The motion-segmentation and odometry records of the 2-process run
    against the 1-process run's; rank 1 wrote neither."""
    rec = {r: json.loads((out / f"eval_{r}.json").read_text()) for r in ("single_rank0", "multi_rank0", "multi_rank1")}
    one, two = rec["single_rank0"]["mot_seg"], rec["multi_rank0"]["mot_seg"]
    counts = max(float(np.abs(np.subtract(one[k], two[k])).max()) for k in ("tp", "fp", "fn")) / WAYMO_PIXELS
    tally = (max(abs(one["fp_tally"][k] - two["fp_tally"][k]) for k in one["fp_tally"]) / WAYMO_PIXELS
             if one["fp_tally"].keys() == two["fp_tally"].keys() else float("inf"))
    z1, z2 = np.load(one["npz"]), np.load(two["npz"])
    curve = max(float(np.abs(z1[k] - z2[k]).max()) for k in ("precision", "recall", "f1"))
    same_ranks = all(rec["multi_rank1"]["mot_seg"][k] == two[k] for k in ("tp", "fp", "fn", "fp_tally"))
    ok = _report(max(counts, tally, curve) <= COUNT_TOL and np.array_equal(z1["thrds"], z2["thrds"]) and same_ranks
                 and not Path(rec["multi_rank1"]["mot_seg"]["npz"]).exists(),
                 "eval.motion_segmentation on tiny_waymo: the 2-process records agree with the 1-process records, "
                 "both ranks hold the summed counts, and rank 1 wrote none",
                 f"tp/fp/fn {counts:.2e} and FP tally {tally:.2e} of the pixels, precision/recall/f1 {curve:.2e} "
                 f"(tolerance {COUNT_TOL:.0e}); tally {two['fp_tally']}")
    a, b = np.load(rec["single_rank0"]["odometry"]["npy"]), np.load(rec["multi_rank0"]["odometry"]["npy"])
    rel = float((np.abs(a - b) / np.abs(a)).max()) if a.shape == b.shape and a.size else float("inf")
    ok &= _report(rel <= ODOM_RTOL and not Path(rec["multi_rank1"]["odometry"]["npy"]).exists()
                  and not Path(rec["multi_rank1"]["odometry"]["txt"]).exists(),
                  "eval.odometry on the 8-frame segment: the 2-process ATE and speeds agree with the 1-process "
                  "record, and rank 1 wrote none", f"{a.shape[0]} tracks, largest relative difference {rel:.2e} "
                  f"(tolerance {ODOM_RTOL:.0e})")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/two_proc")
    ap.add_argument("--epoch_schedules", nargs=4, type=int, default=[1, 0, 0, 0])
    ap.add_argument("--worker", choices=["train", "eval"])
    ap.add_argument("--name", default="")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    args = ap.parse_args(argv)
    if args.worker == "train":
        run_train(args)
        return 0
    if args.worker == "eval":
        run_eval(args)
        return 0

    out = Path(args.out).resolve()
    args.out = str(out)
    out.mkdir(parents=True, exist_ok=True)
    write_splits(out / "splits")
    build_odometry_segment(out / "data")
    schedule = ["--epoch_schedules", *map(str, args.epoch_schedules)]
    print(f"== training: 1 process at batch 2 and 2 processes at batch 1, {H}x{W}, "
          f"{STEPS} steps per phase of {args.epoch_schedules} ==", flush=True)
    _run_both(args, "train", ["--batch", "2"], ["--batch", "1"], schedule)
    records = {r: json.loads((out / f"{r}.json").read_text()) for r in ("single_rank0", "multi_rank0", "multi_rank1")}

    ok = _report(records["multi_rank0"]["world"] == 2 and records["multi_rank0"]["ddp"] == "DistributedDataParallel",
                 "the multi run trained through DistributedDataParallel at world size 2",
                 f"{records['multi_rank0']['world']}, {records['multi_rank0']['ddp']}")
    vals = {r: next(h["scalars"] for h in rec["history"] if h["mode"] == "val") for r, rec in records.items()}
    keys = [k for k in vals["single_rank0"] if k.startswith(("de:", "da:"))]
    single = np.array([vals["single_rank0"][k] for k in keys])
    for r in ("multi_rank0", "multi_rank1"):
        got = np.array([vals[r][k] for k in keys])
        ok &= _report(bool(keys) and np.allclose(got, single, rtol=RTOL, atol=1e-6),
                      f"validation depth metrics of the initial weights, {r} against one process",
                      f"max relative difference {np.max(np.abs(got - single) / np.abs(single)):.2e} over {keys}")

    fingerprints = [records[f"multi_rank{r}"]["fingerprint"] for r in (0, 1)]
    ok &= _report(fingerprints[0] == fingerprints[1], "both ranks' parameters and buffers bit-identical after "
                  "training (state_fingerprint)", f"{fingerprints[0]} and {fingerprints[1]}")

    trained = [p for p, n in zip(PHASE_FOLDERS, args.epoch_schedules) if n > 0]
    models = out / "multi_rank0" / "logs" / "drive" / "models"
    folders = sorted(p.name for p in models.iterdir() if p.is_dir()) if models.is_dir() else []
    ok &= _report(folders == sorted(trained) and not (out / "multi_rank1" / "logs").exists(),
                  "rank 0 alone wrote the checkpoint folders",
                  f"rank 0: {folders}; rank 1's log folder exists: {(out / 'multi_rank1' / 'logs').exists()}")

    ckpt = out / "single_rank0" / "logs" / "drive" / "models" / trained[-1]
    print(f"== eval.depth, eval.motion_segmentation and eval.odometry of {ckpt}: 1 process and 2 processes at a "
          "global batch of 2 ==", flush=True)
    _run_both(args, "eval", extra=["--ckpt", str(ckpt)])
    for dataset in EVAL_DATASETS:
        single_t, multi_t = (table_path(out, n, 0, dataset, ckpt) for n in ("single", "multi"))
        same = single_t.is_file() and multi_t.is_file() and single_t.read_text() == multi_t.read_text()
        ok &= _report(same and not table_path(out, "multi", 1, dataset, ckpt).exists(),
                      f"eval.depth on tiny_{dataset}: the 2-process table equals the 1-process table, "
                      "and rank 1 wrote none", str(multi_t))
    ok &= compare_eval_records(out)
    print("ALL PASS" if ok else "COMPARISONS FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
