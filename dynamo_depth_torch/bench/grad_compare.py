"""One training step on a chosen device, dumped for a backend comparison: the
port's counterpart of the JAX package's ``scripts/grad_compare.py``.

Seed-0 weights, the synthetic batch of ``training/synthetic.py`` (or, with
``--data_path``, the first ``--batch_size`` training files of a scene
rendered by ``bench/bf16_convergence.py``, loaded without augmentation), one
step of ``--phase`` at ``--step_in_phase``; the 0-d loss terms and, per
trainable module, the norm of its parameters' update go to a JSON file with
the JAX script's keys (``platform``, ``phase``, ``losses``,
``update_norms``, the modules by their flax names), so that either
script's ``--diff`` compares a port dump with a JAX dump as it compares two
backends:

    python -m dynamo_depth_torch.bench.grad_compare --device cuda --out build/gc_cuda.json
    python -m dynamo_depth_torch.bench.grad_compare --device cpu --out build/gc_cpu.json
    python -m dynamo_depth_torch.bench.grad_compare --diff build/gc_cpu.json build/gc_cuda.json

Near-equal update norms say the two backends agree on the step; a module
with a very different or zero norm on one of them points at that path.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import torch


def run(args, setup=None) -> dict:
    """One step as ``args`` asks; writes and returns the record. ``setup``,
    if given, is called with the trainer before the step (a test loads other
    weights there)."""
    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.data.loader import collate
    from dynamo_depth_torch.data.splits import read_split
    from dynamo_depth_torch.training.synthetic import synthetic_batch
    from dynamo_depth_torch.training.trainer import Trainer

    kwargs = dict(dataset="kitti")
    if args.data_path:
        os.environ["DYNAMO_SPLITS_DIR"] = osp.join(args.data_path, "splits")
        kwargs.update(split="synth", data_path=args.data_path + "/")
    cfg = DynamoConfig(depth_model=args.depth_model, height=args.height, width=args.width,
                       batch_size=args.batch_size, compute_dtype=args.compute_dtype, no_train_vis=True,
                       num_devices=1, seed=0, weights_init="scratch", **kwargs)
    trainer = Trainer(cfg, device=args.device, phase=args.phase, steps_per_epoch=100)
    if args.data_path:
        filenames = read_split(cfg.split, "train")[:cfg.batch_size]
        ds = trainer.get_dataset(filenames, is_train=False)
        batch = collate([ds.get_item(i) for i in range(len(filenames))])
    else:
        batch = synthetic_batch(cfg, cfg.batch_size, cfg.height, cfg.width)
    if setup is not None:
        setup(trainer)

    params = {m: [p for p in getattr(trainer.model, m).parameters() if p.requires_grad]
              for m in trainer.trainable_modules}
    before = {m: [p.detach().clone() for p in ps] for m, ps in params.items()}
    generator = torch.Generator(device=trainer.device).manual_seed(123)
    losses = trainer.train_step(trainer.to_device(batch), generator, args.step_in_phase)
    norms = {m: float(torch.sqrt(sum(((p.detach() - b) ** 2).sum() for p, b in zip(ps, before[m]))))
             for m, ps in params.items()}
    rec = {
        "platform": trainer.device.type,
        "phase": args.phase,
        "losses": {k: float(v) for k, v in losses.items() if v.ndim == 0},
        "update_norms": norms,
    }
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    print(json.dumps(rec["update_norms"], indent=1, sort_keys=True))
    print("loss:", rec["losses"].get("loss"))
    print("wrote", args.out)
    return rec


def diff(paths):
    """Print the losses and update norms of two dumps side by side, as the
    JAX script's ``--diff`` prints them."""
    a, b = (json.load(open(p)) for p in paths)
    print(f"{'key':38s} {a['platform']:>12s} {b['platform']:>12s}  rel_diff")
    for k in sorted(set(a["losses"]) | set(b["losses"])):
        x, y = a["losses"].get(k, float("nan")), b["losses"].get(k, float("nan"))
        rel = abs(x - y) / max(abs(x), abs(y), 1e-12)
        print(f"loss/{k:33s} {x:12.6f} {y:12.6f}  {rel:8.1%}")
    for k in sorted(set(a["update_norms"]) | set(b["update_norms"])):
        x = a["update_norms"].get(k, float("nan"))
        y = b["update_norms"].get(k, float("nan"))
        rel = abs(x - y) / max(abs(x), abs(y), 1e-12)
        print(f"upd/{k:34s} {x:12.6f} {y:12.6f}  {rel:8.1%}")


def build_parser():
    ap = argparse.ArgumentParser(description="one training step dumped for a backend comparison")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--phase", default="fine_tune")
    ap.add_argument("--depth_model", default="litemono")
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--batch_size", type=int, default=6)
    ap.add_argument("--compute_dtype", default="float32")
    ap.add_argument("--step_in_phase", type=int, default=50)
    ap.add_argument("--data_path", default=None,
                    help="rendered-scene root (bench/bf16_convergence.py's data folder): a deterministic batch "
                         "of its first training files instead of the synthetic one")
    ap.add_argument("--out", default="grad_compare.json")
    ap.add_argument("--diff", nargs=2, default=None)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.diff:
        diff(args.diff)
    else:
        run(args)


if __name__ == "__main__":
    main()
