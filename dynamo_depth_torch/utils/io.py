"""File/naming helpers (reference ``utils.py:9-79,166-182``); the port's
copy of ``dynamo_depth_tpu.utils.io``."""

from __future__ import annotations

import os
import os.path as osp

import numpy as np


def readlines(filename):
    with open(filename, "r") as f:
        return f.read().splitlines()


def write_to_file(data_list, fname, bool_newline=True):
    with open(fname, "w") as fh:
        if bool_newline:
            fh.writelines([d + "\n" for d in data_list])
        else:
            fh.writelines(data_list)


def join_dir(*tree):
    """Join path segments, creating directories as needed (utils.py:70-79)."""
    path = osp.join(*tree)
    os.makedirs(path, exist_ok=True)
    return path


def get_model_ckpt_name(load_path):
    """Parse (model_name, ckpt_name) from a checkpoint path (utils.py:25-49):
    logs/<model>/models/<ckpt>/... or ckpt/<model>/..., else a generic tag."""
    parts = load_path.split("/")
    if "logs" in parts:
        i = parts.index("logs")
        return parts[i + 1], parts[i + 3]
    if "ckpt" in parts:
        return parts[parts.index("ckpt") + 1], "ckpt"
    model_name = "[{}]".format("-".join(parts))
    print(f"Loaded path (={load_path}) does not appear to be under logs/ or ckpt/")
    print(f"\tUsing general model_name=`{model_name}` and ckpt_name=`ckpt`.")
    return model_name, "ckpt"


def get_filenames(segment_name, opt):
    """List '<segment> <index>' entries for every frame of a segment
    (utils.py:51-57)."""
    rgb_dir = osp.join(opt.data_path, segment_name, opt.cam_name, "rgb", opt.eval_img_type)
    frames = sorted(
        int(osp.splitext(f)[0])
        for f in os.listdir(rgb_dir)
        if osp.splitext(f)[1] == opt.eval_img_ext
    )
    return [f"{segment_name} {i}" for i in frames]


def is_edge(filename, opt):
    """True if the frame is at a sequence edge for opt.frame_ids
    (utils.py:59-68)."""
    seg, frame_index = filename.split()[0], int(filename.split()[1])
    lo = frame_index + int(np.min(opt.frame_ids))
    hi = frame_index + int(np.max(opt.frame_ids))
    base = osp.join(opt.data_path, seg, opt.cam_name, "rgb", opt.eval_img_type)
    left = osp.join(base, f"{lo:06}{opt.eval_img_ext}")
    right = osp.join(base, f"{hi:06}{opt.eval_img_ext}")
    return (not osp.exists(left)) or (not osp.exists(right))


def sec_to_hm_str(t):
    t = int(t)
    s = t % 60
    t //= 60
    m = t % 60
    t //= 60
    return f"{t:02d}h{m:02d}m{s:02d}s"
