"""Legacy KITTI dataset variants (reference ``datasets/kitti_dataset.py:171-285``);
the port's copy of ``dynamo_depth_tpu.data.kitti_legacy``.

Not used by the main training or eval path, and not in the dataset
registry, as in the JAX package: raw-velodyne ground truth
(``KITTIRAWDataset``), odometry-split sequences (``KITTIOdomDataset``) and
improved dense depth maps (``KITTIDepthDataset``), all over the *raw* KITTI
directory layout rather than the processed one. The velodyne projection is
the shared ``prepare_data/kitti_util.py`` (numpy only). Where skimage is
installed the raw depth map is resized to the full resolution with it, as
in the JAX package; where it is not, both packages keep the map as
projected.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
from PIL import Image

from dynamo_depth_torch.data.base import BaseDataset, pil_load
from dynamo_depth_torch.data.kitti import KITTIDataset

try:
    import skimage.transform

    _HAS_SKIMAGE = True
except ImportError:
    _HAS_SKIMAGE = False


class KITTIDatasetOld(BaseDataset):
    """Raw-layout KITTI base: fixed normalized intrinsics, l/r side map."""

    K_NORM = KITTIDataset.K_NORM
    FULL_RES = (1242, 375)
    SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}

    def get_intrinsic(self, folder=None):
        return self.K_NORM

    def get_timestep(self, folder, frame_index, offset):
        return 1.0

    def get_gt_dim(self, folder, frame_index, side):
        return self.FULL_RES[1], self.FULL_RES[0]

    def check_depth(self):
        folder, frame_index, _ = self.parse_line(0)
        velo = osp.join(self.data_path, folder, f"velodyne_points/data/{frame_index:010d}.bin")
        return osp.isfile(velo)

    def get_color(self, folder, frame_index, side, do_flip):
        color = pil_load(self.get_image_path(folder, frame_index, side))
        if do_flip:
            color = color.transpose(Image.FLIP_LEFT_RIGHT)
        return color

    def get_img_path(self, folder, frame_index, side):
        return self.get_image_path(folder, frame_index, side)

    def get_image_path(self, folder, frame_index, side):
        raise NotImplementedError


class KITTIRAWDataset(KITTIDatasetOld):
    """Raw velodyne depth maps as dense ground truth."""

    def get_image_path(self, folder, frame_index, side):
        return osp.join(self.data_path, folder, f"image_0{self.SIDE_MAP[side]}/data",
                        f"{frame_index:010d}_192{self.img_ext}")

    def get_depth(self, folder, frame_index, side, do_flip):
        from prepare_data.kitti_util import generate_depth_map

        calib_path = osp.join(self.data_path, folder.split("/")[0])
        velo = osp.join(self.data_path, folder, f"velodyne_points/data/{frame_index:010d}.bin")
        depth = generate_depth_map(calib_path, velo, self.SIDE_MAP[side], vel_depth=True)
        if _HAS_SKIMAGE:
            depth = skimage.transform.resize(depth, self.FULL_RES[::-1], order=0, preserve_range=True,
                                             mode="constant")
        if do_flip:
            depth = np.fliplr(depth)
        return depth


class KITTIOdomDataset(KITTIDatasetOld):
    """Odometry benchmark sequences."""

    def get_image_path(self, folder, frame_index, side):
        return osp.join(self.data_path, f"sequences/{int(folder):02d}", f"image_{self.SIDE_MAP[side]}",
                        f"{frame_index:06d}{self.img_ext}")


class KITTIDepthDataset(KITTIDatasetOld):
    """Improved (annotated) dense ground-truth depth maps."""

    def get_image_path(self, folder, frame_index, side):
        return osp.join(self.data_path, folder, f"image_0{self.SIDE_MAP[side]}/data",
                        f"{frame_index:010d}{self.img_ext}")

    def get_depth(self, folder, frame_index, side, do_flip):
        path = osp.join(self.data_path, folder, f"proj_depth/groundtruth/image_0{self.SIDE_MAP[side]}",
                        f"{frame_index:010d}.png")
        depth = Image.open(path).resize(self.FULL_RES, Image.NEAREST)
        depth = np.asarray(depth).astype(np.float32) / 256
        if do_flip:
            depth = np.fliplr(depth)
        return depth
