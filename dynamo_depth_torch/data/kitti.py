"""KITTI dataset loader (reference ``datasets/kitti_dataset.py:7-128``); the port's copy
of ``dynamo_depth_tpu.data.kitti``.

Fixed normalized intrinsics, l/r -> image_02/image_03 side map, ground-truth
dims read from ``calib_cam_to_cam.txt``, sparse depth from per-frame ``.npy``
point lists with flip handling, motion/semantic masks from ``_mot/_sem.npy``.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
from PIL import Image

from dynamo_depth_torch.data.base import BaseDataset, pil_load


class KITTIDataset(BaseDataset):
    FULL_RES = (1242, 375)  # (W, H)
    SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}

    # Normalized intrinsics (kitti_dataset.py:14-17).
    K_NORM = np.array(
        [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float32
    )

    def get_intrinsic(self, folder):
        return self.K_NORM

    def get_timestep(self, folder, frame_index, offset):
        return 1.0

    def get_gt_dim(self, folder, frame_index, side):
        calib = osp.join(self.data_path, folder, "calib_cam_to_cam.txt")
        tag = f"S_rect_0{self.SIDE_MAP[side]}"
        with open(calib) as f:
            line = [l for l in f.read().splitlines() if tag in l][0]
        _, width, height = line.split()
        return int(float(height)), int(float(width))

    def clamp_frame_index(self, frame_index):
        # sequence start: frame -1 maps to 0 (kitti_dataset.py:79-80)
        return 0 if frame_index == -1 else frame_index

    def _cam(self, side):
        return f"image_0{self.SIDE_MAP[side]}"

    def get_img_path(self, folder, frame_index, side):
        return osp.join(
            self.data_path, folder, self._cam(side), "rgb", self.img_type,
            f"{frame_index:010}{self.img_ext}",
        )

    def get_color(self, folder, frame_index, side, do_flip):
        if frame_index == -1:  # clamp at sequence start (kitti_dataset.py:79-80)
            frame_index = 0
        img = pil_load(self.get_img_path(folder, frame_index, side))
        if do_flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return img

    def get_depth(self, folder, frame_index, side, do_flip):
        if frame_index == -1:
            frame_index = 0
        path = osp.join(
            self.data_path, folder, self._cam(side), "depth", f"{frame_index:010}.npy"
        )
        depth = np.load(path)  # (N, 3) rows [h, w, z]
        if do_flip:
            depth[:, 1] = self.FULL_RES[0] - depth[:, 1]
        # clamp out-of-bound coords (kitti_dataset.py:99-104)
        depth[:, 0] = np.minimum(depth[:, 0], self.FULL_RES[1] - 1)
        depth[:, 1] = np.minimum(depth[:, 1], self.FULL_RES[0] - 1)
        return depth

    def get_mask(self, folder, frame_index, side, do_flip):
        if frame_index == -1:
            frame_index = 0
        base = osp.join(self.data_path, folder, self._cam(side), "mask")
        mot_path = osp.join(base, f"{frame_index:010}_mot.npy")
        sem_path = osp.join(base, f"{frame_index:010}_sem.npy")
        shape = self.FULL_RES[::-1]
        if not osp.exists(sem_path):
            return np.zeros(shape), np.zeros(shape)
        sem = np.load(sem_path)
        mot = np.load(mot_path)
        if mot.shape[:2] != shape:
            sem = np.asarray(
                Image.fromarray(sem.astype(np.uint8)).resize(self.FULL_RES, Image.NEAREST)
            )
            mot = np.asarray(
                Image.fromarray(mot.astype(np.uint8)).resize(self.FULL_RES, Image.NEAREST)
            )
        return sem, mot
