"""Depth evaluation CLI (port of the JAX package's ``eval/depth.py``).

    python -m dynamo_depth_torch.eval.depth -l CKPT -d DATASET [flags]

Part 1: overall depth metrics on ``<split>/test_files.txt``.
Part 2 (waymo, nuscenes): metrics per motion class (background, static,
moving) on ``test_mask_files.txt``, the mask sampled at the LiDAR points.
Writes ``<eval_dir>/<model>_<dataset>/depth/<ckpt>.txt`` in the reference's
table format. Runs on the card unless ``device="cpu"`` is passed.

Under torchrun (``torchrun --nproc_per_node N -m dynamo_depth_torch.eval.depth
...``) the ``--batch_size`` global batch, rounded up to a multiple of N, is
split into N contiguous row slices, one per process; the metrics are reduced
over the processes, and rank 0 alone prints and writes the table, the same
table as one process writes.
"""

import os.path as osp

import numpy as np
import torch

from dynamo_depth_torch.config import parse_config
from dynamo_depth_torch.data.loader import padded_eval_batches
from dynamo_depth_torch.data.splits import read_split
from dynamo_depth_torch.ops.geometry import disp_to_depth
from dynamo_depth_torch.ops.metrics import DEPTH_METRIC_NAMES
from dynamo_depth_torch.parallel import init_distributed, is_main_process, rank, world_size
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_torch.utils.io import get_model_ckpt_name, join_dir, write_to_file

MASK_LABELS = {"bg": 0, "static": 2, "mot": 1}


def display_str(l):
    return "".join(["{:^15s}".format(m) for m in l])


def sample_mask_at_points(mot_mask, depth_gt):
    """Host-side integer gather of mask labels at LiDAR point coords
    (tools.py:56 semantics: mask[h.long(), w.long()])."""
    B, N, _ = depth_gt.shape
    out = np.zeros((B, N), np.int32)
    for b in range(B):
        h = np.clip(depth_gt[b, :, 0].astype(np.int64), 0, mot_mask.shape[1] - 1)
        w = np.clip(depth_gt[b, :, 1].astype(np.int64), 0, mot_mask.shape[2] - 1)
        out[b] = mot_mask[b][h, w]
    return out


def _scored_batches(cfg, trainer, dataset, eval_bs):
    """(this rank's rows of the host batch, real count of the global batch,
    prediction with ('disp_scaled', 0, 0), 1/0 weights of this rank's real
    samples) for each padded global batch of ``eval_bs`` rows of ``dataset``."""
    local = eval_bs // world_size()
    lo = rank() * local
    for batch, real_idxs in padded_eval_batches(dataset, eval_bs, cfg.num_workers, shard=(rank(), world_size())):
        outputs = trainer.predict(batch)
        outputs[("disp_scaled", 0, 0)], _ = disp_to_depth(outputs[("disp", 0, 0)], cfg.min_depth, cfg.max_depth)
        weight = np.zeros((eval_bs,), np.float32)
        weight[:len(real_idxs)] = 1.0
        yield batch, len(real_idxs), outputs, weight[lo:lo + local]


def main(argv=None, device=None):
    """Parse ``argv`` (default: the command line), evaluate and write the
    table. Returns ``{"path": txt path, "lines": the table's lines}``."""
    cfg = parse_config(argv)
    init_distributed(device)
    cfg.print_opt = False
    cfg.frame_ids = [0]  # only the target frame is needed (eval/depth.py:28)
    cfg.img_ext = cfg.eval_img_ext

    model_name, ckpt_name = get_model_ckpt_name(cfg.load_ckpt)
    outdir = osp.join(cfg.eval_dir, f"{model_name}_{cfg.dataset}", "depth")
    out_path = osp.join(outdir, f"{ckpt_name}.txt")
    out = []

    trainer = Trainer(cfg, device=device)
    # The global batch, rounded up to whole rows per process.
    eval_bs = -(-cfg.batch_size // world_size()) * world_size()
    metric_names = list(DEPTH_METRIC_NAMES)
    header = display_str(["Split"] + metric_names)
    out.append(f"====== Model Path - {cfg.load_ckpt} ======\n")

    # --- Part 1: overall ---------------------------------------------------
    out.append("====== Depth Eval on Overall Test Set ======\n")
    filenames = read_split(cfg.split, "test")
    if not filenames:
        raise ValueError(f"split {cfg.split} lists no test files")
    dataset = trainer.get_dataset(filenames, load_depth=True, img_type=cfg.eval_img_type)
    out.append(f"=== len={len(dataset)} ===")
    out.append(header)

    totals = np.zeros(len(metric_names))
    total_num = 0
    for bi, (batch, real, outputs, weight) in enumerate(_scored_batches(cfg, trainer, dataset, eval_bs)):
        met = trainer.depth_metrics(batch, outputs, sample_weight=weight)
        totals += np.array(torch.stack([met[m] for m in metric_names]).tolist()) * real
        total_num += real
        if bi % 50 == 0 and is_main_process():
            print(f"(1/2) depth eval {bi * eval_bs}/{len(dataset)}", flush=True)

    out.append(display_str(["OVERALL"] + ["& {:.3f}".format(t / total_num) for t in totals]))
    out.append("\n")

    # --- Part 2: mask-conditioned ------------------------------------------
    out.append("====== Depth Eval on Test Set with Segmentation Annotations ======\n")
    if cfg.dataset == "kitti":
        out.append("Mask Split Evaluation Skipped for KITTI.")
    else:
        filenames = read_split(cfg.split, "test_mask")
        if not filenames:
            raise ValueError(f"split {cfg.split} lists no test_mask files")
        dataset = trainer.get_dataset(filenames, load_depth=True, load_mask=True, img_type=cfg.eval_img_type)
        out.append(f"=== len={len(dataset)} ===")
        out.append(header)

        keys = [f"{m}_mask/{lbl}" for lbl in MASK_LABELS.values() for m in metric_names]
        agg = np.zeros((len(keys), 2))  # (sum of metric x count, count)
        for bi, (batch, real, outputs, weight) in enumerate(_scored_batches(cfg, trainer, dataset, eval_bs)):
            mask_pts = sample_mask_at_points(batch["mot_mask"], batch["depth_gt"])
            met = trainer.depth_metrics(batch, outputs, mask_pts=mask_pts, labels=tuple(MASK_LABELS.values()),
                                        sample_weight=weight)
            agg += np.array(torch.stack([torch.stack(met[k]) for k in keys]).tolist())
            if bi % 50 == 0 and is_main_process():
                print(f"(2/2) mask depth eval {bi * eval_bs}/{len(dataset)}", flush=True)

        agg = agg.reshape(len(MASK_LABELS), len(metric_names), 2)
        for split, rows in zip(MASK_LABELS, agg):
            out.append(display_str([split.upper()] + ["& {:.3f}".format(s / max(c, 1)) for s, c in rows]))
        out.append("\n")

    if is_main_process():
        for s in out:
            print(s)
        join_dir(outdir)
        write_to_file(out, out_path)
    return {"path": out_path, "lines": out}


if __name__ == "__main__":
    main()
