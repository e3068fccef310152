"""Per-segment visualisation CLI (port of the JAX package's
``eval/visualize.py``).

    python -m dynamo_depth_torch.eval.visualize -l CKPT -d DATASET [flags]

Writes one mp4 per test segment with the columns [img, disp, ego_flow,
ind_flow, mask] under ``<eval_dir>/<model>_<dataset>/vis/<ckpt>/``, or its
frames as PNGs where no mp4 encoder is installed. ``get_vis`` and
``combine_vis`` are reused by the quick demo. The model runs on the card;
the colour coding runs on the host in the JAX package's channels-last
layout.
"""

import os.path as osp

import numpy as np
import torch

from dynamo_depth_torch.config import parse_config
from dynamo_depth_torch.data.loader import collate
from dynamo_depth_torch.data.splits import read_split
from dynamo_depth_torch.ops.geometry import backproject, disp_to_depth, project, transformation_from_parameters
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_torch.utils.io import get_filenames, get_model_ckpt_name, is_edge, join_dir
from dynamo_depth_torch.utils.layout import outputs_to_host
from dynamo_depth_torch.utils.vis import hsv_to_rgb, make_mp4, score_map_vis, vis_motion


def get_vis(cfg, trainer, batch, ref_frame_id, scale=0, items=("img", "disp", "ego_flow", "ind_flow", "mask")):
    """Raw visualisations of one batch (eval/visualize.py:24-88)."""
    s = scale
    f_id = ref_frame_id
    outputs = outputs_to_host(trainer.predict(batch, bool_CmpFlow=True, bool_MotMask=True))

    col = {}
    if "img" in items:
        col["img"] = np.asarray(batch[("color", 0, 0)])
    if "ref_img" in items:
        col["ref_img"] = np.asarray(batch[("color", f_id, 0)])
    if "disp" in items:
        col["disp"] = outputs[("disp", 0, s)]
    if "mask" in items:
        col["mask"] = outputs[("motion_mask", f_id, s)]

    if any("flow" in it for it in items):
        _, depth = disp_to_depth(outputs[("disp", 0, s)], cfg.min_depth, cfg.max_depth)
        K, inv_K = batch[("K", s)], batch[("inv_K", s)]
        ts = np.asarray(batch[("ts", f_id)]).reshape(-1, 1)
        aa = torch.as_tensor(outputs[("axisangle", 0, f_id)] / ts)
        tr = torch.as_tensor(outputs[("translation", 0, f_id)] / ts)
        camTcam = transformation_from_parameters(aa, tr, invert=True).numpy()

        if "ego_flow" in items:
            hsv, mag = vis_motion(depth, K, inv_K, motion_map=None, camTcam=camTcam)
            col["ego_flow"] = {"hsv": hsv, "mag": mag}

        if "ind_flow" in items or "samp_flow" in items:
            pts = backproject(torch.as_tensor(depth[..., 0]), torch.as_tensor(inv_K))
            _, ego_flow = project(pts, torch.as_tensor(K), torch.as_tensor(camTcam),
                                  height=depth.shape[1], width=depth.shape[2])
            ego_flow = ego_flow.numpy().reshape(depth.shape[0], depth.shape[1], depth.shape[2], 3)
            independ = outputs[("motion_mask", f_id, s)] * (outputs[("complete_flow", f_id, s)] - ego_flow)
            hsv, mag = vis_motion(depth, K, inv_K, motion_map=independ, camTcam=None)
            col["ind_flow"] = {"hsv": hsv, "mag": mag}

        if "comp_flow" in items:
            hsv, mag = vis_motion(depth, K, inv_K, motion_map=outputs[("complete_flow", f_id, s)], camTcam=None)
            col["comp_flow"] = {"hsv": hsv, "mag": mag}

        if "samp_flow" in items:
            hsv, mag = vis_motion(depth, K, inv_K, motion_map=independ, camTcam=camTcam)
            col["samp_flow"] = {"hsv": hsv, "mag": mag}

    return col


def combine_vis(vis_list, arrangement, consistent_flow=True, flow_mag_factor=1.0, mask_max_mag=1.0):
    """Aggregate visualisations into stacked uint8 frames
    (eval/visualize.py:90-125)."""
    frames = []
    if consistent_flow and any("flow" in a for arr in arrangement for a in arr):
        max_flow_mag = max(
            max(vis[a]["mag"] for arr in arrangement for a in arr if "flow" in a)
            for vis in vis_list
        )

    for vis in vis_list:
        rows = []
        for arr in arrangement:
            cols = []
            for a in arr:
                out = vis[a]
                if "img" in a:
                    out = out[0]
                elif a == "mask":
                    out = score_map_vis(out, "hot", vminmax=(0, mask_max_mag))
                elif a == "disp":
                    out = score_map_vis(out, "plasma", vminmax=(0, 1))
                elif "flow" in a:
                    if consistent_flow:
                        max_mag = flow_mag_factor * max_flow_mag
                    else:
                        max_mag = flow_mag_factor * max(
                            vis[b]["mag"] for arr2 in arrangement for b in arr2 if "flow" in b
                        )
                    hsv = out["hsv"].copy()
                    hsv[..., 2] = np.clip(hsv[..., 2] * out["mag"] / max_mag, 0, 1)
                    out = (1 - hsv_to_rgb(hsv))[0]
                else:
                    raise ValueError(f"Arrangement name (={a}) not recognized.")
                cols.append((out * 255).astype(np.uint8))
            rows.append(np.hstack(cols))
        frames.append(np.vstack(rows))
    return frames


def vis_segment(cfg, trainer, segment, outdir):
    """Frames of every non-edge frame of ``segment``, written as one mp4;
    -> (frames, the path written)."""
    arrangement = [["img", "disp", "ego_flow", "ind_flow", "mask"]]

    filenames = [f for f in get_filenames(segment, cfg) if not is_edge(f, cfg)]
    dataset = trainer.get_dataset(filenames, img_type=cfg.eval_img_type)

    vis_list = [dict() for _ in range(len(dataset))]
    for i in range(len(dataset)):
        batch = collate([dataset.get_item(i)])
        frame_vis = get_vis(cfg, trainer, batch, ref_frame_id=cfg.frame_ids[1], scale=0, items=arrangement[0])
        f_index = int(dataset.parse_line(i)[1]) - 1
        vis_list[f_index].update(frame_vis)

    out_frames = combine_vis(vis_list, arrangement)
    out_vid = osp.join(outdir, "{}.mp4".format(segment.split("/")[1]))
    fps = 13 if cfg.dataset == "nuscenes" else 10
    written = make_mp4(out_frames, out_vid, fps=fps, bgr=False)
    print(f"Saved to `{out_vid}`\n")
    return out_frames, written


def main(argv=None, device=None):
    """Parse ``argv`` (default: the command line) and write every test
    segment's video. Returns ``{segment: (frames, path written)}``."""
    cfg = parse_config(argv)
    cfg.num_workers = 1
    cfg.batch_size = 1
    cfg.print_opt = False

    model_name, ckpt_name = get_model_ckpt_name(cfg.load_ckpt)
    outdir = join_dir(cfg.eval_dir, f"{model_name}_{cfg.dataset}", "vis", ckpt_name)

    trainer = Trainer(cfg, device=device)

    files = read_split(cfg.split, "test")
    segments = sorted({f.split()[0] for f in files})
    out = {}
    for ii, segment in enumerate(segments):
        print(f"{ii + 1}/{len(segments)} segments - {segment}")
        out[segment] = vis_segment(cfg, trainer, segment, outdir)
    return out


if __name__ == "__main__":
    main()
