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
   displacement;
5. one ``fine_tune`` step on the card against the same step on the CPU (the
   plain versions) from the same weights at 64x96;
6. the main path: the LiteMono ``fine_tune`` step at 192x640, batch 3,
   float32 (KITTI headline config, random weights from seed 0): 2 warm-up
   and 5 timed steps, finite losses, moving weights, and 6 launches per step
   of each of the four kernels; then one profiled step, with each kernel's
   own device time inside it; then one more step whose six warp inputs are
   captured, with each grid's displacement and the warp kernels and
   ``F.grid_sample``'s forward and backward (``grid_sampler_2d``) timed alone
   on them.

Prints one ``{"kernels": [...]}`` line, then, last, the
``{"ok": true, "device": {...}}`` line.
"""

import json
import math
import subprocess
import sys
import time

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


def max_err(a, b):
    return float((a - b).detach().abs().max())


def check(name, err, tol):
    ok = err <= tol
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.1e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from dynamo_depth_torch.bench.timing import device_ms, median_ms, self_device_us
    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.ops import ground_plane
    from dynamo_depth_torch.ops.kernels import build, launch_counts, photometric, reset_launch_counts, warp
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
    timings, wall = {}, {}
    for key, fns in calls.items():
        dev_t = [None if fn is None else device_ms(fn) for fn in fns]
        wall_t = [None if fn is None else median_ms(fn) for fn in fns]
        # Without device activity in the profile, fall back to the events.
        timings[key] = [d if d is not None or w is None else w for d, w in zip(dev_t, wall_t)]
        wall[key] = wall_t
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
        print(f"  {k}{where}: kernel {ms:.4f} (wall {w[0]:.4f}) | plain {plain} "
              f"| library {lib} | bound {bounds[k][0]:.4f} ({bounds[k][1]})")

    # ---- 5. the step on the card against the step on the CPU --------------
    small = DynamoConfig(dataset="kitti", height=64, width=96, batch_size=2, weights_init="scratch")
    torch.manual_seed(0)
    t_gpu = Trainer(small, device="cuda", drop_path_rate=0.0)
    t_cpu = Trainer(small, device="cpu", drop_path_rate=0.0)
    t_cpu.model.load_state_dict({k: v.cpu() for k, v in t_gpu.model.state_dict().items()})
    batch_small = synthetic_batch(small, 2, 64, 96)
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
    print(f"fine_tune step at 64x96, card (kernels) vs CPU (plain): worst relative loss difference "
          f"{rel[worst]:.2e} in {worst} (tolerance {tol[worst]:.0e}); d_ground {rel['loss_term/d_ground']:.2e}")
    if rel[worst] > tol[worst]:
        raise SystemExit(f"card step disagrees with the CPU step: {results}")
    del t_gpu, t_cpu

    # ---- 6. the main path: fine_tune at 192x640, batch 3 -------------------
    cfg = DynamoConfig(dataset="kitti", depth_model="litemono", batch_size=B, weights_init="scratch")
    trainer = Trainer(cfg)  # the card, float32, drop-path 0.4
    batch = trainer.to_device(synthetic_batch(cfg, B, cfg.height, cfg.width))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
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
            raise SystemExit(f"step {step}: non-finite losses {bad}")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = STEPS_WARMUP + STEPS_TIMED
    expected = 6 * steps
    for k, n in counts.items():
        if n != expected:
            raise SystemExit(f"{k}: {n} launches in {steps} steps, expected {expected}")
    # Every watched weight that receives a gradient has moved (the dilated
    # blocks' unused LayerNorm receives none).
    trained = [(n, p) for n, p in trainer.model.named_parameters() if n in watch and p.grad is not None]
    frozen = [n for n, p in trained if torch.equal(p.detach(), watch[n])]
    if not trained or frozen:
        raise SystemExit(f"weights that did not move: {frozen} of {len(trained)} watched")
    ms = float(np.median(step_ms[STEPS_WARMUP:]))
    print(f"fine_tune LiteMono {cfg.height}x{cfg.width} batch {B} float32 on {smi}: "
          f"{ms:.2f} ms/step (median of {STEPS_TIMED}; warm-up {step_ms[0]:.1f}, {step_ms[1]:.1f} ms), "
          f"{B / ms * 1e3:.2f} examples/s, peak memory {peak / 2**30:.2f} GiB; "
          f"loss {float(losses['loss']):.6f}; launches {counts}")

    # ---- where the step's device time goes (one extra step, profiled) ------
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch, gen, steps)
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
    print(f"profiled step: wall {wall_ms:.1f} ms (profiler on), device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.0f}% of wall; {100 * busy_ms / ms:.0f}% of the unprofiled step), "
          f"{sum(e.count for e in events)} device ops; top by device time:")
    for e in events[:15]:
        print(f"  {self_device_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:100]}")
    ours = sum(self_device_us(e) for e in events if any(n in e.key for n in ("warp_", "photometric_")))
    print(f"  the four port kernels: {ours / 1e3:.3f} ms ({100 * ours / 1e3 / max(busy_ms, 1e-9):.2f}% of device time)")
    in_step = {}  # device ms of one launch inside the step, by kernel
    for k in ("warp_fwd", "warp_bwd", "photometric_fwd", "photometric_bwd"):
        mine = [e for e in events if f"{k}_kernel" in e.key]
        n = sum(e.count for e in mine)
        if n != 6:
            raise SystemExit(f"{k}: {n} launches in the profiled step, expected 6")
        in_step[k] = sum(self_device_us(e) for e in mine) / 1e3 / n
        bench = timings[(k, "ego" if k.startswith("warp") else None)][0]
        print(f"  {k}: {in_step[k]:.4f} ms per launch in the step (x{n}), {bench:.4f} ms alone"
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
    # device ms alone on each captured input: the kernels, and the library's
    # forward and backward (grid_sampler_2d, d_grid only, as in the step)
    on_step = {"warp_fwd": [], "warp_bwd": []}
    lib_step = {"warp_fwd": [], "warp_bwd": []}
    print(f"the step's warp inputs, kernels and F.grid_sample alone on each (device ms; in the step: "
          f"warp_fwd {in_step['warp_fwd']:.4f}, warp_bwd {in_step['warp_bwd']:.4f} per launch):")
    for i, (im, gr) in enumerate(captured):
        if not bool(torch.isfinite(gr).all()):
            raise SystemExit(f"step grid {i} is not finite")
        g_req = gr.clone().requires_grad_()
        out_lib = F.grid_sample(im, g_req, mode="bilinear", padding_mode="border", align_corners=True)
        on_step["warp_fwd"].append(device_ms(lambda: warp.warp_fwd(im, gr)))
        on_step["warp_bwd"].append(device_ms(lambda: warp.warp_bwd(im, gr, g_warp, False)))
        lib_step["warp_fwd"].append(device_ms(
            lambda: F.grid_sample(im, gr, mode="bilinear", padding_mode="border", align_corners=True)))
        lib_step["warp_bwd"].append(device_ms(lambda: torch.autograd.grad(out_lib, g_req, g_warp, retain_graph=True)))
        print(f"  grid {i}: {displacement(gr)}; warp_fwd {on_step['warp_fwd'][i]:.4f} "
              f"(library {lib_step['warp_fwd'][i]:.4f}), warp_bwd {on_step['warp_bwd'][i]:.4f} "
              f"(library {lib_step['warp_bwd'][i]:.4f})")
    for k in on_step:
        ours, lib = float(np.mean(on_step[k])), float(np.mean(lib_step[k]))
        print(f"  {k} on the step's grids: mean {ours:.4f} ms, library {lib:.4f} ms "
              f"({'kernel faster' if ours < lib else 'library faster'})")
    del captured, out_lib

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
            "launches": counts[k], "launches_per_step": counts[k] / steps, "max_abs_err": errors[k],
            "ms": ms_k, "plain_ms": plain_ms, "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
            "library_ms": lib_ms, "wall_ms": wall[(k, "uniform" if warp_k else None)][0],
            "in_step_ms": in_step[k],
        }
        if warp_k:  # "ms", "plain_ms", "library_ms" above are on the uniform grid
            ms_e, plain_e, lib_e = timings[(k, "ego")]
            entry.update({"ms_ego_grid": ms_e, "plain_ms_ego_grid": plain_e, "library_ms_ego_grid": lib_e,
                          "wall_ms_ego_grid": wall[(k, "ego")][0],
                          "ms_step_grids": float(np.mean(on_step[k])),
                          "library_ms_step_grids": float(np.mean(lib_step[k]))})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels, "step_ms": ms, "examples_per_s": B / ms * 1e3,
                      "peak_bytes": peak, "card": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
