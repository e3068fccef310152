"""Odometry evaluation CLI (port of the JAX package's ``eval/odometry.py``).

    python -m dynamo_depth_torch.eval.odometry -l CKPT -d DATASET [flags]

Per test segment (the first 100): pose prediction frame by frame (0 -> +1,
batched), scale-aligned ATE of 5-frame tracks against ``odometry.txt``
(SfMLearner protocol), aggregated to mean/std/min/median/max with the
speeds. Writes ``record_<ckpt>-5.txt`` and ``.npy`` under
``<eval_dir>/<model>_<dataset>/odometry/``. waymo and nuscenes only.

Under torchrun (``torchrun --nproc_per_node N -m dynamo_depth_torch.eval.odometry
...``) the ``--batch_size`` global batch, rounded up to a multiple of N, is
split into N contiguous row slices, one per process; the poses of the slices
are gathered in rank order into the global batch on every process, and
rank 0 alone prints and writes the records, the same records as one process
writes.
"""

import os.path as osp

import numpy as np

from dynamo_depth_torch.config import parse_config
from dynamo_depth_torch.data.loader import padded_eval_batches
from dynamo_depth_torch.data.splits import read_split
from dynamo_depth_torch.ops.geometry import transformation_from_parameters
from dynamo_depth_torch.parallel import all_gather_rows, init_distributed, is_main_process, rank, world_size
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_torch.utils.io import get_filenames, get_model_ckpt_name, is_edge, join_dir, write_to_file

TRACK_LENGTH = 5
STOP_SEGMENT = 100


def dump_xyz(source_to_target_transformations):
    """Chain local transforms into global xyz (SfMLearner)."""
    xyzs = []
    cam_to_world = np.eye(4)
    xyzs.append(cam_to_world[:3, 3])
    for T in source_to_target_transformations:
        cam_to_world = np.dot(cam_to_world, T)
        xyzs.append(cam_to_world[:3, 3])
    return xyzs


def compute_ate(gtruth_xyz, pred_xyz_o):
    """Scale-aligned absolute trajectory error (SfMLearner)."""
    offset = gtruth_xyz[0] - pred_xyz_o[0]
    pred_xyz = pred_xyz_o + offset[None, :]
    scale = np.sum(gtruth_xyz * pred_xyz) / np.sum(pred_xyz ** 2)
    alignment_error = pred_xyz * scale - gtruth_xyz
    return np.sqrt(np.sum(alignment_error ** 2)) / gtruth_xyz.shape[0]


def eval_odom(cfg, trainer, segment, track_length):
    filenames = [f for f in get_filenames(segment, cfg) if not is_edge(f, cfg)]
    dataset = trainer.get_dataset(filenames, img_type=cfg.eval_img_type)
    N = len(filenames)
    # The global batch, rounded up to whole rows per process.
    eval_bs = -(-cfg.batch_size // world_size()) * world_size()

    # Batched pose prediction (the reference runs batch-size-1 frame by
    # frame, odometry.py:44-68): each process predicts its rows, and the
    # global batch's poses are gathered in rank order.
    pred_poses = np.zeros((N, 4, 4), np.float64)
    for batch, real_idxs in padded_eval_batches(dataset, eval_bs, cfg.num_workers, shard=(rank(), world_size())):
        outputs = trainer.predict(batch, bool_CmpFlow=False, bool_MotMask=False)
        T = all_gather_rows(transformation_from_parameters(outputs[("axisangle", 0, 1)], outputs[("translation", 0, 1)],
                                                           invert=False)).cpu().numpy()
        for ii, ind in enumerate(real_idxs):
            pred_poses[ind] = T[ii]

    gt_path = osp.join(cfg.data_path, segment, cfg.cam_name, "odometry.txt")
    gt_global = np.loadtxt(gt_path)[1:]  # ignore the first frame
    if gt_global.shape[0] != N + 1:
        raise ValueError(f"{gt_path} holds {gt_global.shape[0] + 1} poses; {N} frames away from the edges need {N + 2}")
    gt_global = gt_global.reshape(N + 1, -1, 4)
    if gt_global.shape[1] == 3:
        gt_global = np.concatenate((gt_global, np.zeros((gt_global.shape[0], 1, 4))), 1)
        gt_global[:, 3, 3] = 1
    gt_xyzs = gt_global[:, :3, 3]
    gt_local = [
        np.linalg.inv(np.dot(np.linalg.inv(gt_global[i - 1]), gt_global[i]))
        for i in range(1, len(gt_global))
    ]

    ates, speeds = [], []
    num_frames = gt_xyzs.shape[0]
    for i in range(0, num_frames - 1):
        local_xyzs = np.array(dump_xyz(pred_poses[i : i + track_length - 1]))
        gt_local_xyzs = np.array(dump_xyz(gt_local[i : i + track_length - 1]))
        if local_xyzs.shape[0] < track_length - 1:
            continue
        # shift axes (z, x, y) (odometry.py:91)
        local_xyzs = np.concatenate((local_xyzs[:, 2:3], local_xyzs[:, 0:1], local_xyzs[:, 1:2]), 1)
        ates.append(compute_ate(gt_local_xyzs, local_xyzs))
        speeds.append(np.sqrt(((gt_local_xyzs[1:] - gt_local_xyzs[:-1]) ** 2).sum(1)).mean())
    return ates, speeds


def main(argv=None, device=None):
    """Parse ``argv`` (default: the command line), evaluate and write the
    records. Returns ``{"txt": path, "npy": path, "ates": [...],
    "speeds": [...]}``."""
    cfg = parse_config(argv)
    init_distributed(device)
    cfg.frame_ids = [0, -1, 1]
    cfg.print_opt = False
    if cfg.dataset not in ("waymo", "nuscenes"):
        raise ValueError(f"{cfg.dataset} is not supported.")

    model_name, ckpt_name = get_model_ckpt_name(cfg.load_ckpt)
    outdir = osp.join(cfg.eval_dir, f"{model_name}_{cfg.dataset}", "odometry")
    txt_path = osp.join(outdir, f"record_{ckpt_name}-{TRACK_LENGTH}.txt")
    npy_path = osp.join(outdir, f"record_{ckpt_name}-{TRACK_LENGTH}.npy")

    trainer = Trainer(cfg, device=device)

    files = read_split(cfg.split, "test")
    segments = sorted({f.split()[0] for f in files})[:STOP_SEGMENT]

    output = [f"=== track_length: {TRACK_LENGTH}"]
    all_ates, all_speeds = [], []
    for segment in segments:
        ates, speeds = eval_odom(cfg, trainer, segment, TRACK_LENGTH)
        all_ates += ates
        all_speeds += speeds
        output.append(
            f"{segment:50s} Track={TRACK_LENGTH} ATE: {np.mean(ates):0.3f} ± {np.std(ates):0.3f},  "
            f"Speed: {np.mean(speeds):0.3f} ± {np.std(speeds):0.3f},  Len: {len(all_ates)}"
        )
        if is_main_process():
            print(output[-1], flush=True)

    for title, values, end in ((f"ATE Trajectory error (Track={TRACK_LENGTH})", all_ates, "=="),
                               ("Speed", all_speeds, "--")):
        output.append(f"\n{title}:  ")
        output.append(f"Mean:   {np.mean(values)}")
        output.append(f"std:    {np.std(values)}")
        output.append("--")
        output.append(f"Min:    {np.min(values)}")
        output.append(f"Median: {np.median(values)}")
        output.append(f"Max:    {np.max(values)}")
        output.append(end)
    output.append(f"len:    {len(all_speeds)}")

    if is_main_process():
        for s in output:
            print(s)
        join_dir(outdir)
        write_to_file(output, txt_path)
        np.save(npy_path, np.stack((np.array(all_ates), np.array(all_speeds))).transpose((1, 0)))
    return {"txt": txt_path, "npy": npy_path, "ates": all_ates, "speeds": all_speeds}


if __name__ == "__main__":
    main()
