"""Waymo Open dataset loader (reference ``datasets/waymo_dataset.py:9-120``); the port's copy
of ``dynamo_depth_tpu.data.waymo``.

Per-segment normalized intrinsics from ``cam.json``, 1920x1280 full-res,
depth ``.npy`` reordered to [h, w, z], motion mask rasterized from pickled
per-object contours with a speed > 1.0 m/s moving threshold.
"""

from __future__ import annotations

import json
import os.path as osp
import pickle

import numpy as np
from PIL import Image

from dynamo_depth_torch.data.base import BaseDataset, pil_load

try:
    import cv2
except ImportError:  # cv2 draws the motion masks, which only evaluation loads
    cv2 = None


class WaymoDataset(BaseDataset):
    FULL_RES = (1920, 1280)  # (W, H)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._K = {}

    def get_intrinsic(self, folder):
        if folder not in self._K:
            K = np.eye(4, dtype=np.float32)
            with open(self._seg_cam_dir(folder, "rgb", "cam.json")) as fh:
                K[:3, :3] = np.array(json.load(fh)["intrinsic_mat"])
            self._K[folder] = K
        return self._K[folder]

    def get_timestep(self, folder, frame_index, offset):
        return 1.0

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
        # reorder to [h, w, z] (waymo_dataset.py:89-91)
        return np.concatenate((depth[:, 1:2], depth[:, 0:1], depth[:, 2:3]), axis=1)

    def get_mask(self, folder, frame_index, side, do_flip):
        sem_path = self._seg_cam_dir(folder, "mask", f"{frame_index:06d}.npz")
        mot_path = self._seg_cam_dir(folder, "mask", f"{frame_index:06d}.pickle")
        shape = self.FULL_RES[::-1]
        if not osp.exists(sem_path):
            return np.zeros(shape), np.zeros(shape)

        sem = np.load(sem_path)["semantic"].squeeze()
        with open(mot_path, "rb") as fh:
            motion_labels = pickle.load(fh)

        mot = np.zeros(shape)
        for obj in motion_labels:
            contours = obj["mask"]
            if obj["box_label"] is None:
                label = 3  # unlabeled
            elif np.sqrt(np.sum(np.array(obj["speed"]) ** 2)) > 1.0:
                label = 1  # in motion
            else:
                label = 2  # static
            cv2.drawContours(mot, contours, -1, label, -1)
        return sem, mot
