"""Binary motion segmentation evaluation CLI (port of the JAX package's
``eval/motion_segmentation.py``).

    python -m dynamo_depth_torch.eval.motion_segmentation -l CKPT -d DATASET [flags]

Pass 1: sweep 150 thresholds over the predicted motion mask (frame -1,
scale 0, upsampled to the dataset's full resolution), accumulating tp/fp/fn
against the ground-truth motion labels (1 moving, 2 static, 3 unlabeled),
on the device. Saves the npz record and the PR curve pdf. Pass 2 (waymo
only): tally false positives by semantic class at the best-F1 threshold
into a bar chart. The pdfs need matplotlib; where it is missing, the CLI
says which pdf it did not write, and the npz is written all the same.

Under torchrun (``torchrun --nproc_per_node N -m
dynamo_depth_torch.eval.motion_segmentation ...``) the ``--batch_size``
global batch, rounded up to a multiple of N, is split into N contiguous row
slices, one per process. Each process counts and tallies its own rows; the
counts (whole numbers: fewer than 2^24 pixels per batch) and the tally are
summed over the processes in float64, which keeps them exact, and rank 0
alone prints and writes the records, the same records as one process writes.
"""

import os.path as osp

import numpy as np
import torch

from dynamo_depth_torch.config import parse_config
from dynamo_depth_torch.data.categories import WAYMO_CATEGORIES
from dynamo_depth_torch.data.loader import padded_eval_batches
from dynamo_depth_torch.data.splits import read_split
from dynamo_depth_torch.ops.seg_metrics import pr_sweep_counts
from dynamo_depth_torch.ops.warp import resize_bilinear
from dynamo_depth_torch.parallel import all_reduce_sum, init_distributed, is_main_process, rank, world_size
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_torch.utils.io import get_model_ckpt_name, is_edge, join_dir

NUM_THRD = 150


def pyplot():
    """matplotlib's pyplot, or None where matplotlib is not installed."""
    try:
        from matplotlib import pyplot as plt
    except ImportError:
        return None
    return plt


def _plot_pr_curve(plt, precision, recall, path):
    fig = plt.figure()
    plt.axhline(y=precision[0], linestyle=":")
    plt.plot(recall[recall > 0], precision[recall > 0])
    plt.xlim(0, 1)
    plt.ylim(0, 1)
    plt.xlabel("Recall")
    plt.ylabel("Precision")
    plt.title("Motion Segmentation PR Curve")
    fig.savefig(path)
    plt.clf()


def _plot_fp_tally(plt, fp_tally, best_f1_thrd, best_f1, path):
    fig = plt.figure()
    fig.set_size_inches(20, 10)
    cats, cnts = [], []
    for c_idx, cnt in fp_tally.items():
        if c_idx != "total":
            cats.append(WAYMO_CATEGORIES[int(c_idx)])
            cnts.append(cnt / fp_tally["total"])
    order = np.argsort(cnts)[::-1]
    plt.bar(np.array(cats)[order], np.array(cnts)[order])
    plt.tick_params(axis="x", labelrotation=60)
    plt.ylim([0, 1])
    plt.ylabel("False Positive Rate")
    plt.title(f"Motion Segmentation False Positive Tally - Thrd {best_f1_thrd:.2f} - Macro F1 {best_f1:.3f}")
    fig.savefig(path)


def _my_rows(real_idxs, eval_bs):
    """(row of this rank's slice, global dataset index) of each real sample
    among this rank's rows of a padded global batch."""
    local = eval_bs // world_size()
    lo = rank() * local
    return [(ii, real_idxs[lo + ii]) for ii in range(local) if lo + ii < len(real_idxs)]


def main(argv=None, device=None):
    """Parse ``argv`` (default: the command line), evaluate and write the
    records. Returns ``{"npz": path, "pdfs": pdfs written, "missing": pdfs
    not written, "tp"/"fp"/"fn": counts per threshold, "fp_tally": the
    waymo tally or None}``: the counts and the tally on every rank, the
    pdfs on rank 0, which alone writes."""
    cfg = parse_config(argv)
    init_distributed(device)
    cfg.frame_ids = [0, -1, 1]
    cfg.print_opt = False
    main_process = is_main_process()

    model_name, ckpt_name = get_model_ckpt_name(cfg.load_ckpt)
    outdir = osp.join(cfg.eval_dir, f"{model_name}_{cfg.dataset}", "mot_seg")
    pr_curve_path = osp.join(outdir, f"pr_curve_{ckpt_name}.pdf")
    pr_record_path = osp.join(outdir, f"pr_record_{ckpt_name}.npz")
    fp_tally_path = osp.join(outdir, f"fp_tally_{ckpt_name}.pdf")

    trainer = Trainer(cfg, device=device)
    # The global batch, rounded up to whole rows per process.
    eval_bs = -(-cfg.batch_size // world_size()) * world_size()
    shard = (rank(), world_size())

    filenames = read_split(cfg.split, "test_mask")
    filenames = [f for f in filenames if not is_edge(f, cfg)]
    if not filenames:
        raise ValueError(f"split {cfg.split} lists no test_mask file away from a sequence's edges")
    dataset = trainer.get_dataset(filenames, load_mask=True, img_type=cfg.eval_img_type)
    full_w, full_h = dataset.FULL_RES
    trainer.print(f"=== len={len(dataset)} ===")

    eps = 1 / (NUM_THRD - 1)
    thrds = np.linspace(0 - eps, 1 - eps, NUM_THRD).astype(np.float32)
    motion_pred = {}  # this rank's predictions, by dataset index
    dev = trainer.device
    counts = torch.zeros(3, NUM_THRD, dtype=torch.float64, device=dev)  # tp, fp, fn

    # All 150 thresholds in one bucketization and histogram on the device
    # (ops/seg_metrics.py); only the (T,) counts come back to the host.
    thrds_dev = torch.as_tensor(thrds, device=dev)
    need_pred_host = cfg.dataset == "waymo"  # pass 2 reuses per-image preds

    for bi, (batch, real_idxs) in enumerate(padded_eval_batches(dataset, eval_bs, cfg.num_workers, shard=shard)):
        outputs = trainer.predict(batch, bool_CmpFlow=True, bool_MotMask=True)
        pred = resize_bilinear(outputs[("motion_mask", -1, 0)], (full_h, full_w))[:, 0]
        gt = torch.as_tensor(batch["mot_mask"]).to(dev)
        mine = _my_rows(real_idxs, eval_bs)
        weight = np.zeros((pred.shape[0],), np.float32)
        weight[[ii for ii, _ in mine]] = 1.0
        counts += torch.stack(pr_sweep_counts(pred, gt, thrds_dev, torch.as_tensor(weight, device=dev))).double()

        if need_pred_host:
            pred_host = pred.cpu().numpy()
            for ii, ind in mine:
                motion_pred[ind] = pred_host[ii]
        if bi % 20 == 0 and main_process:
            print(f"(1/2) thresholds {bi * eval_bs}/{len(dataset)}", flush=True)

    all_reduce_sum([counts])
    record = dict(zip(("tp", "fp", "fn"), counts.cpu().numpy()))
    precision = record["tp"] / (record["tp"] + record["fp"] + 1e-10)
    recall = record["tp"] / (record["tp"] + record["fn"] + 1e-10)
    f1 = 2 * (precision * recall) / (precision + recall + 1e-10)
    plt = pyplot() if main_process else None
    written, missing = [], []
    if main_process:
        join_dir(outdir)
        np.savez(pr_record_path, precision=precision, recall=recall, f1=f1, thrds=thrds.reshape(1, NUM_THRD, 1, 1))
        print(f"PR record saved to `{pr_record_path}`.")
        if plt is None:
            missing.append(pr_curve_path)
            print(f"matplotlib is not installed: the PR curve `{pr_curve_path}` was not written.")
        else:
            _plot_pr_curve(plt, precision, recall, pr_curve_path)
            written.append(pr_curve_path)
            print(f"PR curve saved to `{pr_curve_path}`.")

    fp_tally = None
    if cfg.dataset == "waymo":  # waymo has semantic labels, nuscenes does not
        best_f1_thrd = float(thrds[int(np.argmax(f1))])
        # False-positive pixels by semantic label, over WAYMO_CATEGORIES' indices.
        tally = np.zeros(len(WAYMO_CATEGORIES), np.float64)
        for bi, (batch, real_idxs) in enumerate(padded_eval_batches(dataset, eval_bs, cfg.num_workers, shard=shard)):
            for ii, ind in _my_rows(real_idxs, eval_bs):
                gt_b = batch["mot_mask"][ii] == 1
                valid_b = batch["mot_mask"][ii] != 3
                sem = batch["sem_mask"][ii]
                pm = motion_pred[ind] > best_f1_thrd
                fp_b = np.logical_and(pm > gt_b, valid_b)
                labels = sem[fp_b].astype(np.int64)
                if labels.size and labels.max() >= len(tally):
                    raise ValueError(f"semantic label {labels.max()} is not one of WAYMO_CATEGORIES' indices")
                tally += np.bincount(labels, minlength=len(tally))
            if bi % 20 == 0 and main_process:
                print(f"(2/2) fp tally {bi * eval_bs}/{len(dataset)}", flush=True)
        tally = torch.as_tensor(tally, device=dev)
        all_reduce_sum([tally])
        tally = tally.cpu().numpy()
        fp_tally = {"total": int(tally.sum()), **{label: int(n) for label, n in enumerate(tally) if n}}
        if main_process and plt is None:
            missing.append(fp_tally_path)
            print(f"matplotlib is not installed: the FP tally `{fp_tally_path}` was not written "
                  f"(tally {({str(k): int(v) for k, v in fp_tally.items()})}).")
        elif main_process:
            _plot_fp_tally(plt, fp_tally, best_f1_thrd, float(np.max(f1)), fp_tally_path)
            written.append(fp_tally_path)
            print(f"FP tally saved to `{fp_tally_path}`.")

    return {"npz": pr_record_path, "pdfs": written, "missing": missing, "fp_tally": fp_tally, **record}


if __name__ == "__main__":
    main()
