"""Time this checkout's CUDA kernels against another checkout's, on one card.

    git archive <commit> | tar -x -C build/other      # any git-ignored directory
    python3 -m dynamo_depth_torch.bench.kernel_ab --other build/other \
        [--step-inputs build/chip_smoke/step_warp_inputs.pt] [--cold]

Both checkouts' ``csrc/*.cu`` export the same C functions (``warp_fwd``,
``warp_bwd``, ``photometric_fwd``, ``photometric_bwd``), declared once in
the wrappers (``ops/kernels/warp.py`` and ``ops/kernels/photometric.py``).
The other checkout's own ``ops/kernels/build.py`` builds its sources into
its own ``build/kernels``. The script feeds both sets of kernels the same
tensors at the main path's shapes (B=3, C=3, 192x640), the warp on a
uniform random grid in [-1.1, 1.1] and on a stand-in for a trained model's
ego-motion (``training/synthetic.py::ego_motion_grid``), and the backwards
also at exact ties (K2 on the uniform grid clipped to [-1, 1], K4 where
pred equals target), reports how far the two disagree, and times each in
turns (other, this, this, other) with
``bench/timing.py``: device time per call from ``torch.profiler``, and the
median of CUDA events around one call. ``--step-inputs`` adds the warp's
inputs of one step, as ``chip_smoke.py`` phase 6 saves them (six images and
grids at B=3) or phase 15 (bfloat16 images at B=8,
``step_warp_inputs_b8.pt``): K1 and K2 run on each, with one random
gradient per batch size. ``--cold`` times every call after a 64 MB
overwrite, as the step's kernels find their inputs in device memory.
Where both checkouts export K1's and K2's bfloat16-image instances
(``warp_fwd_bf16``, ``warp_bwd_bf16``), those run too, on every warp input
with the image rounded to bfloat16. Prints the card, one line per kernel
and grid, and one JSON object last.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from dynamo_depth_torch.bench.timing import TIMED_RUNS, device_ms, median_ms
from dynamo_depth_torch.ops.kernels import build
from dynamo_depth_torch.ops.kernels import photometric as photometric_wrapper
from dynamo_depth_torch.ops.kernels import warp as warp_wrapper
from dynamo_depth_torch.training.synthetic import ego_motion_grid

B, C, H, W = 3, 3, 192, 640


def _other_build(root: Path):
    spec = importlib.util.spec_from_file_location(
        "other_kernels_build", root / "dynamo_depth_torch" / "ops" / "kernels" / "build.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WARP_BF16 = ("warp_fwd_bf16", "warp_bwd_bf16")


def _warp_lib(builder, names):
    return builder.load("warp", {k: warp_wrapper._SIGNATURES[k] for k in names})


def _exports_bf16(builder):
    """Whether a checkout's warp library has the bfloat16-image instances
    (an older checkout has only the float32 ones)."""
    lib = _warp_lib(builder, ("warp_fwd", "warp_bwd"))
    return all(hasattr(lib, k) for k in WARP_BF16)


def _launchers(builder, t, bf16):
    """{(kernel, inputs): (launch, output)} for one checkout's libraries;
    ``bf16``: with the warp's bfloat16-image instances."""
    warp = _warp_lib(builder, ("warp_fwd", "warp_bwd") + (WARP_BF16 if bf16 else ()))
    photo = builder.load("photometric", photometric_wrapper._SIGNATURES)
    s = torch.cuda.current_stream().cuda_stream
    out = {}
    warp_inputs = [("uniform grid", t["img"], t["grid"]), ("ego grid", t["img"], t["ego"]),
                   ("on-border grid", t["img"], t["on_border"])]
    warp_inputs += [(f"step grid {i}", im, gr) for i, (im, gr) in enumerate(t["step"])]
    for label, img32, grid in warp_inputs:
        n, c, h, w = img32.shape  # the step's inputs may have another batch
        g_warp = t["g_warp"][n]
        for suffix, img in (("", img32),) + ((("_bf16", img32.bfloat16()),) if bf16 else ()):
            fwd, bwd = getattr(warp, "warp_fwd" + suffix), getattr(warp, "warp_bwd" + suffix)
            o = torch.empty(n, c, h, w, device="cuda")
            d = torch.empty_like(grid)
            if label != "on-border grid":
                out[("warp_fwd" + suffix, label)] = (
                    lambda o=o, img=img, grid=grid, fwd=fwd, n=n, c=c, h=h, w=w: build.check(fwd(img.data_ptr(), grid.data_ptr(), o.data_ptr(), n, c, h, w, h, w, s), "warp_fwd"),
                    o,
                )
            out[("warp_bwd" + suffix, label)] = (
                lambda d=d, img=img, grid=grid, bwd=bwd, n=n, c=c, h=h, w=w, g=g_warp: build.check(bwd(img.data_ptr(), grid.data_ptr(), g.data_ptr(), d.data_ptr(), None, n, c, h, w, h, w, s), "warp_bwd"),
                d,
            )
    o = torch.empty(B, 1, H, W, device="cuda")
    out[("photometric_fwd", None)] = (
        lambda: build.check(photo.photometric_fwd(t["pred"].data_ptr(), t["target"].data_ptr(), o.data_ptr(), B, C, H, W, 0.85, s), "photometric_fwd"),
        o,
    )
    for label, target in ((None, t["target"]), ("pred == target", t["pred"])):
        d = torch.empty(B, C, H, W, device="cuda")
        out[("photometric_bwd", label)] = (
            lambda d=d, target=target: build.check(photo.photometric_bwd(t["pred"].data_ptr(), target.data_ptr(), t["g_photo"].data_ptr(), d.data_ptr(), None, B, C, H, W, 0.85, s), "photometric_bwd"),
            d,
        )
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="root of the other checkout")
    ap.add_argument("--calls", type=int, default=TIMED_RUNS, help="calls per timing")
    ap.add_argument("--step-inputs", type=Path,
                    help="the warp's inputs of one step, saved by chip_smoke.py phase 6 (B=3) or 15 (B=8)")
    ap.add_argument("--cold", action="store_true",
                    help="overwrite 64 MB before each timed call, as a kernel in the step finds its inputs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)

    gen = torch.Generator(device="cuda").manual_seed(0)
    t = {
        "img": torch.rand(B, C, H, W, device="cuda", generator=gen),
        "grid": torch.rand(B, H, W, 2, device="cuda", generator=gen) * 2.2 - 1.1,
        "g_warp": {B: torch.randn(B, C, H, W, device="cuda", generator=gen)},
        "pred": torch.rand(B, C, H, W, device="cuda", generator=gen),
        "target": torch.rand(B, C, H, W, device="cuda", generator=gen),
        "g_photo": torch.randn(B, 1, H, W, device="cuda", generator=gen),
        "ego": ego_motion_grid(B, H, W, seed=0).cuda(),
    }
    t["on_border"] = t["grid"].clamp(-1.0, 1.0)
    t["step"] = []
    if args.step_inputs is not None:
        saved = torch.load(args.step_inputs, map_location="cuda")
        # A batch-8 step's images are bfloat16: the float32 instances run on
        # them widened, the bfloat16 ones on them as they are.
        t["step"] = [(im.float(), gr) for im, gr in zip(saved["images"], saved["grids"])]
        n = t["step"][0][0].shape[0]
        if any(im.shape != (n, C, H, W) or gr.shape != (n, H, W, 2) for im, gr in t["step"]):
            raise SystemExit(f"{args.step_inputs}: the step's warp inputs are not of shape {(n, C, H, W)}")
        t["g_warp"].setdefault(n, torch.randn(n, C, H, W, device="cuda", generator=gen))
    other = _other_build(args.other.resolve())
    bf16 = _exports_bf16(other) and _exports_bf16(build)
    sets = {"other": _launchers(other, t, bf16), "this": _launchers(build, t, bf16)}

    diffs = {}
    for key in sets["this"]:
        for side in ("other", "this"):
            sets[side][key][0]()
        torch.cuda.synchronize()
        diffs[key] = float((sets["this"][key][1] - sets["other"][key][1]).abs().max())

    times = {key: {"other": [], "this": []} for key in sets["this"]}
    for side in ("other", "this", "this", "other"):
        for key, (fn, _) in sets[side].items():
            times[key][side].append((device_ms(fn, args.calls, cold=args.cold), median_ms(fn, args.calls)))

    rows = []
    print(f"device ms per call (profiler{', cold L2' if args.cold else ''}; events around one call in brackets), "
          f"B={B} C={C} {H}x{W} (the step's inputs: their own batch), turns other/this/this/other, on {smi}:")
    for key, by in times.items():
        row = {"kernel": key[0], "inputs": key[1], "max_abs_diff": diffs[key]}
        for side in ("other", "this"):
            dev = [d for d, _ in by[side] if d is not None]
            row[f"{side}_ms"] = sum(dev) / len(dev) if dev else None
            row[f"{side}_ms_runs"] = dev
            row[f"{side}_event_ms"] = sum(e for _, e in by[side]) / len(by[side])
        rows.append(row)
        where = "" if key[1] is None else f" [{key[1]}]"

        def fmt(v):
            return "n/a" if v is None else f"{v:.5f}"

        print(f"  {key[0]}{where}: other {fmt(row['other_ms'])} ({row['other_event_ms']:.5f}) | "
              f"this {fmt(row['this_ms'])} ({row['this_event_ms']:.5f}) | max abs diff {diffs[key]:.2e}")
    summary = {}
    for k in ("warp_fwd", "warp_bwd") + WARP_BF16:
        step_rows = [r for r in rows if r["kernel"] == k and str(r["inputs"]).startswith("step grid")]
        if step_rows and all(r["other_ms"] is not None and r["this_ms"] is not None for r in step_rows):
            summary[k] = {side: sum(r[f"{side}_ms"] for r in step_rows) / len(step_rows) for side in ("other", "this")}
            print(f"  {k} [mean of {len(step_rows)} step grids]: other {summary[k]['other']:.5f} | "
                  f"this {summary[k]['this']:.5f}")
    print(json.dumps({"card": smi, "cold": args.cold, "kernel_ab": rows, "step_grid_means": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
