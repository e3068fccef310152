"""nuScenes dataset loader (reference ``datasets/nuscenes_dataset.py:10-97``); the port's copy
of ``dynamo_depth_tpu.data.nuscenes``.

Per-scene normalized intrinsics, **variable timesteps** (sums of per-frame ms
durations from ``ts.json`` divided by the 100 ms median — feeding the
``('ts', f)`` factor that scales complete flow in the warp), and a motion
mask reconstructed by scattering LiDAR motion labels into a /5-downsampled
grid then nearest-upsampling.
"""

from __future__ import annotations

import json
import os.path as osp

import numpy as np
from PIL import Image

from dynamo_depth_torch.data.base import BaseDataset, pil_load


class nuScenesDataset(BaseDataset):
    FULL_RES = (1600, 900)  # (W, H)
    MEDIAN_TS = 100.0  # ms (nuscenes_dataset.py:20)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._K = {}
        self._ts = {}

    def get_intrinsic(self, folder):
        if folder not in self._K:
            K = np.eye(4, dtype=np.float32)
            with open(self._seg_cam_dir(folder, "rgb", "cam.json")) as fh:
                K[:3, :3] = np.array(json.load(fh)["intrinsic_mat"])
            self._K[folder] = K
        return self._K[folder]

    def get_timestep(self, folder, frame_index, offset):
        if folder not in self._ts:
            with open(self._seg_cam_dir(folder, "rgb", "ts.json")) as fh:
                self._ts[folder] = json.load(fh)
        ts = self._ts[folder]
        low = min(frame_index, frame_index + offset)
        high = max(frame_index, frame_index + offset)
        return float(np.sum(ts[low:high]) / self.MEDIAN_TS)

    def get_gt_dim(self, folder, frame_index, side):
        return self.FULL_RES[1], self.FULL_RES[0]

    def get_img_path(self, folder, frame_index, side):
        return self._seg_cam_dir(folder, "rgb", self.img_type, f"{frame_index:06d}{self.img_ext}")

    def get_color(self, folder, frame_index, side, do_flip):
        img = pil_load(self.get_img_path(folder, frame_index, side))
        if do_flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return img

    def get_depth(self, folder, frame_index, side, do_flip):
        path = self._seg_cam_dir(folder, "depth", f"{frame_index:06d}.npy")
        depth = np.load(path)  # (N, 3) rows [w, h, z] on disk
        if do_flip:
            depth[:, 0] = self.FULL_RES[0] - depth[:, 0]
        return np.concatenate((depth[:, 1:2], depth[:, 0:1], depth[:, 2:3]), axis=1)

    def get_mask(self, folder, frame_index, side, do_flip):
        mask_path = self._seg_cam_dir(folder, "mask", f"{frame_index:06d}.npz")
        shape = self.FULL_RES[::-1]
        if not osp.exists(mask_path):
            return np.ones(shape), np.ones(shape) * 3

        motion_seg = np.load(mask_path)["motion_label"]
        pts = self.get_depth(folder, frame_index, side, do_flip=False)

        # Scatter labels into a /5 grid, then nearest-upsample
        # (nuscenes_dataset.py:82-96).
        scale = 5
        org_w, org_h = self.FULL_RES
        dwn_w, dwn_h = org_w // scale, org_h // scale
        coord = (pts[:, :2] / scale).astype(np.int64)
        coord = np.clip(coord, 0, None)
        coord[:, 0] = np.minimum(coord[:, 0], dwn_h - 1)
        coord[:, 1] = np.minimum(coord[:, 1], dwn_w - 1)

        mot = np.full((dwn_h, dwn_w), 3.0, dtype=np.float32)
        mot[coord[:, 0], coord[:, 1]] = np.asarray(motion_seg, dtype=np.float32)
        mot = np.asarray(
            Image.fromarray(mot).resize((org_w, org_h), Image.NEAREST), dtype=np.float32
        )
        return np.ones(shape), mot
