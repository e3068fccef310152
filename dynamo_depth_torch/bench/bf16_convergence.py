"""float32 against bfloat16 training, on a scene whose depth is known.

    python -m dynamo_depth_torch.bench.bf16_convergence --out build/bf16_convergence \\
        [--height 96 --width 320 --steps-per-epoch 100 --epochs 2 1 1 2]

The port's counterpart of the JAX package's ``scripts/bf16_convergence.py``:
it trains the four-phase curriculum of LiteMono twice from seed 0, with
``compute_dtype="float32"`` and ``"bfloat16"``, on a geometrically
consistent synthetic KITTI sequence, and compares the validation depth
metrics (abs_rel, rms, a1, ..., median-scaled as the reference's
``DepthMetrics`` scales them), not only the losses.

The scene is exactly renderable from any camera position: a ground plane
1.5 m below the camera, a frontal wall and two side walls, each textured by
a fixed sum of cosines of its world surface coordinates, seen by a camera
that moves ``DZ`` metres forward per frame. Every frame and its
ground-truth depth agree, so a photometric pipeline that converges drives
abs_rel down (up to the monocular scale that median scaling removes).

Writes ``<out>/bf16_convergence.json``: per dtype the validation records,
the mean of the last ``FINAL_RECORDS`` of them, the wall time and the
training steps' median ms; and the card's name and power limit. Runs on the
card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import tempfile
import time

import numpy as np

CAM_HEIGHT = 1.5  # m, ground plane below the optical axis
WALL_MARGIN = 20.0  # m between the last camera position and the front wall
CORRIDOR_HALF_W = 7.0  # m, side walls' distance from the camera axis
FX_N, FY_N = 0.58, 1.92  # the KITTI loader's normalized intrinsics
DZ = 0.75  # m the camera moves forward per frame
DEPTH_KEYS = ("de:abs_rel", "de:sq_rel", "de:rms", "da:a1", "da:a2", "da:a3")
FINAL_RECORDS = 5  # validation records averaged for the final metrics (one batch each)
SEQ = "2011_09_26/2011_09_26_drive_0001_sync"


def _texture(rng, a, b, octaves=2, fa=None, fb=None):
    """RGB texture over world surface coordinates (a, b): random cosines in
    two octaves, with absolute brightness, so a surface looks the same from
    every frame.

    ``fa`` / ``fb``: each pixel's footprint in texture units, for analytic
    anti-aliasing. Foreshortening pushes the ground's texture far past the
    pixel rate near the horizon, and the alias pattern would change with the
    camera's position. The box filter of one pixel is exact per cosine: each
    is attenuated by a Gaussian in its frequency per pixel, so the far field
    converges to the texture's local mean."""
    k = 24
    f = rng.uniform(-3.0, 3.0, (2, k))
    ph = rng.uniform(0, 2 * np.pi, (3, k))
    amp = rng.uniform(0.3, 1.0, (3, k)) / np.sqrt(k)
    out, norm = 0.0, 0.0
    for o in range(octaves):
        arg = (a[..., None] * f[0] + b[..., None] * f[1]) * (2 ** o)
        gain = 1.0
        if fa is not None:
            nu = (np.abs(f[0]) * fa[..., None] + np.abs(f[1]) * fb[..., None]) * (2 ** o)  # cycles per pixel
            gain = np.exp(-0.5 * (np.pi * nu) ** 2)
        chans = [np.sum(amp[c] * gain * np.cos(2 * np.pi * arg + ph[c]), -1) for c in range(3)]
        out = out + np.stack(chans, -1) * (0.6 ** o)
        norm += 0.6 ** o
    return np.clip(0.5 + 0.55 * out / norm, 0.0, 1.0)


def render_scene(root, width, height, n_frames, gt_stride=3, ss=2):
    """Write an ``n_frames`` KITTI-layout sequence under ``root`` (JPEGs,
    sparse ground-truth depth, calibration) and a ``synth`` split with train
    and val files; returns the splits directory.

    ``ss``: the frames are rendered at ``ss`` times the resolution and
    box-filtered down. The front wall stands ``WALL_MARGIN`` past the last
    camera position, so the camera never reaches it."""
    from PIL import Image

    base = osp.join(root, SEQ, "image_02")
    os.makedirs(osp.join(base, "rgb", "downsample"), exist_ok=True)
    os.makedirs(osp.join(base, "depth"), exist_ok=True)
    wall_z = n_frames * DZ + WALL_MARGIN
    seeds = dict(ground=1, front=2, left=3, right=4)
    eps = 1e-6

    def rays(w, h):
        uu, vv = np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h)
        return (uu - 0.5) / FX_N, (vv - 0.5) / FY_N  # (x/z, y/z)

    def surfaces(rx, ry, cam_z):
        """Camera-frame depth of each surface along each ray (inf: missed)."""
        inf = np.full_like(rx, np.inf)
        return {
            "ground": np.where(ry > eps, CAM_HEIGHT / np.maximum(ry, eps), inf),
            "front": np.full_like(rx, np.maximum(wall_z - cam_z, 1.0)),
            "left": np.where(rx < -eps, CORRIDOR_HALF_W / np.maximum(-rx, eps), inf),
            "right": np.where(rx > eps, CORRIDOR_HALF_W / np.maximum(rx, eps), inf),
        }

    rx_hi, ry_hi = rays(width * ss, height * ss)
    rx_lo, ry_lo = rays(width, height)
    for i in range(n_frames):
        cam_z = i * DZ
        surf = surfaces(rx_hi, ry_hi, cam_z)
        names = list(surf)
        pick = np.argmin(np.stack([surf[n] for n in names]), axis=0)
        img = np.zeros((height * ss, width * ss, 3), np.float32)
        for k, name in enumerate(names):
            zs = surf[name]
            if name == "ground":
                ta, tb = rx_hi * zs, zs + cam_z  # world x, z
            elif name == "front":
                ta, tb = rx_hi * zs, ry_hi * zs  # world x, y
            else:
                ta, tb = zs + cam_z, ry_hi * zs  # world z, y
            finite = np.isfinite(zs)
            ta = np.where(finite, ta, 0.0).astype(np.float32) * 0.35
            tb = np.where(finite, tb, 0.0).astype(np.float32) * 0.35
            tex = _texture(np.random.RandomState(seeds[name]), ta, tb,
                           fa=np.hypot(*np.gradient(ta)), fb=np.hypot(*np.gradient(tb)))
            img = np.where((pick == k)[..., None], tex, img)
        img = img.reshape(height, ss, width, ss, 3).mean(axis=(1, 3))
        Image.fromarray((img * 255).astype(np.uint8)).save(
            osp.join(base, "rgb", "downsample", f"{i:010}.jpg"), quality=95)
        # Sparse ground truth on a grid, within the evaluation range.
        z = np.min(np.stack(list(surfaces(rx_lo, ry_lo, cam_z).values())), axis=0)
        hh, ww = np.meshgrid(np.arange(0, height, gt_stride), np.arange(0, width, gt_stride), indexing="ij")
        zz = z[hh, ww]
        keep = zz < 60.0
        np.save(osp.join(base, "depth", f"{i:010}.npy"),
                np.stack([hh[keep], ww[keep], zz[keep]], -1).astype(np.float32))

    with open(osp.join(root, SEQ, "calib_cam_to_cam.txt"), "w") as f:
        f.write(f"S_rect_02: {width:.6e} {height:.6e}\nS_rect_03: {width:.6e} {height:.6e}\n")
    splits = osp.join(root, "splits", "synth")
    os.makedirs(splits, exist_ok=True)
    n_val = max(n_frames // 4, 4)
    train_hi = n_frames - n_val - 2
    with open(osp.join(splits, "train_files.txt"), "w") as f:
        f.write("".join(f"{SEQ} {i} l\n" for i in range(1, train_hi)))
    with open(osp.join(splits, "val_files.txt"), "w") as f:
        f.write("".join(f"{SEQ} {i} l\n" for i in range(train_hi + 1, n_frames - 1)))
    return osp.join(root, "splits")


def run_one(compute_dtype, data_root, args, device, log_dir):
    """Train the curriculum in ``compute_dtype``, its checkpoints under
    ``log_dir``; -> its summary."""
    import torch

    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.training import trainer as trainer_mod

    cfg = DynamoConfig(
        dataset="kitti", split="synth", data_path=data_root + "/", depth_model="litemono", height=args.height,
        width=args.width, batch_size=args.batch_size, compute_dtype=compute_dtype, learning_rate=1e-4,
        weights_init="scratch", epoch_size=args.steps_per_epoch, epoch_schedules=list(args.epochs),
        log_frequency=args.val_every, no_train_vis=True, num_workers=2, seed=0,
        log_dir=log_dir, model_name=f"conv_{compute_dtype}", print_opt=False,
    )
    trainer = trainer_mod.Trainer(cfg, device=device)
    on_card = trainer.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    step_ms = []
    run_step = trainer.train_step

    def timed_step(batch, generator, step):
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        sync()
        t0 = time.perf_counter()
        losses = run_step(batch, generator, step)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return losses

    trainer.train_step = timed_step
    t0 = time.perf_counter()
    trainer.train()
    wall_s = time.perf_counter() - t0
    val = [dict(h["scalars"], g_step=h["g_step"], phase=h["phase"]) for h in trainer.history if h["mode"] == "val"]
    scored = [r for r in val if "de:abs_rel" in r]
    if not scored:
        raise RuntimeError(f"{compute_dtype}: no validation record carries depth metrics")
    last = scored[-FINAL_RECORDS:]
    final = {k: float(np.mean([r[k] for r in last])) for k in DEPTH_KEYS + ("loss",)}
    return {"final": final, "last_record": scored[-1], "history": val, "wall_s": wall_s,
            "steps": len(step_ms), "median_step_ms": float(np.median(step_ms)),
            "peak_bytes": torch.cuda.max_memory_allocated() if on_card else None}


def card_name():
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0]


def build_parser():
    ap = argparse.ArgumentParser(description="float32 against bfloat16 training on a synthetic scene")
    ap.add_argument("--out", default="build/bf16_convergence")
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--batch_size", type=int, default=6)
    ap.add_argument("--steps-per-epoch", dest="steps_per_epoch", type=int, default=100)
    ap.add_argument("--epochs", type=int, nargs=4, default=[2, 1, 1, 2], help="epochs of each curriculum phase")
    ap.add_argument("--val_every", type=int, default=25)
    ap.add_argument("--n_frames", type=int, default=48)
    return ap


def main(argv=None, device=None) -> dict:
    """Render the scene, train once per dtype, write and return the summary."""
    args = build_parser().parse_args(argv)
    data_root = osp.join(args.out, "data")
    t0 = time.perf_counter()
    os.environ["DYNAMO_SPLITS_DIR"] = render_scene(data_root, args.width, args.height, args.n_frames)
    print(f"scene rendered under {data_root} in {time.perf_counter() - t0:.1f} s", flush=True)
    results = {}
    for dt in ("float32", "bfloat16"):
        print(f"==== training compute_dtype={dt} ====", flush=True)
        # The checkpoints (about 500 MB per phase) are not part of the result.
        with tempfile.TemporaryDirectory() as log_dir:
            results[dt] = run_one(dt, data_root, args, device, log_dir)
    summary = {"card": card_name() if device is None or str(device).startswith("cuda") else None,
               "config": vars(args), "results": results}
    with open(osp.join(args.out, "bf16_convergence.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\n==== depth metrics, mean of the last {FINAL_RECORDS} validation records ====")
    for dt, r in results.items():
        print(f"{dt:10s} {r['steps']} steps, {r['median_step_ms']:.2f} ms/step, {r['wall_s']:.1f} s  "
              + "  ".join(f"{k}={r['final'][k]:.4f}" for k in DEPTH_KEYS))
    print(json.dumps({dt: r["final"] for dt, r in results.items()} | {"card": summary["card"]}))
    return summary


if __name__ == "__main__":
    main()
