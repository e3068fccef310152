"""Base dataset: triplet loading + host-side augmentation (the port's copy of
``dynamo_depth_tpu.data.base``; items equal that package's exactly).

Capability parity with ``datasets/base_dataset.py:21-219``:

- per-item random horizontal flip (p=0.5, base_dataset.py:125) and one shared
  ColorJitter transform applied identically to all frames at p=0.5
  (base_dataset.py:165-170);
- bicubic PIL resize to (height, width) when the stored image differs
  (base_dataset.py:80,146-147);
- intrinsics pyramid: K scaled by (W/2^s, H/2^s) with inv_K = pinv(K)
  (base_dataset.py:154-163);
- LiDAR depth as a padded point list of 25k [h, w, z] rows + validity mask
  (base_dataset.py:78,172-183);
- per-frame timesteps via :meth:`get_timestep` (constant 1 except nuScenes).

Returns plain numpy dicts with the reference's key scheme —
``('color'|'color_aug', frame_id, 0)``, ``('K'|'inv_K', scale)``, ``('ts',
frame_id)``, ``'depth_gt'``, ``'depth_valid'``, ``'gt_dim'``, ``'index'`` —
images as (H, W, 3) float32 in [0, 1] (NHWC after batching).

Images are decoded by the native data plane when its library builds
(``data/native.py``), else by PIL; :func:`decode_counts` says which path
decoded how many frames.
"""

from __future__ import annotations

import os.path as osp
import threading
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from dynamo_depth_torch.data.augment import ColorJitter

MAX_LIDAR_NUM = 25000  # pad size for batching (base_dataset.py:78)

# Frames decoded by each path since the last reset (loader threads add to it).
_DECODES = {"native": 0, "pil": 0}
_DECODES_LOCK = threading.Lock()


def decode_counts() -> Dict[str, int]:
    """{"native": frames, "pil": frames} decoded since the last reset."""
    with _DECODES_LOCK:
        return dict(_DECODES)


def reset_decode_counts() -> None:
    with _DECODES_LOCK:
        for k in _DECODES:
            _DECODES[k] = 0


def _count_decodes(path: str, n: int) -> None:
    with _DECODES_LOCK:
        _DECODES[path] += n


def pil_load(path: str) -> Image.Image:
    with open(path, "rb") as f:
        with Image.open(f) as img:
            return img.convert("RGB")


class BaseDataset:
    def __init__(
        self,
        data_path: str,
        filenames: List[str],
        height: int,
        width: int,
        cam_name: str,
        img_type: str,
        frame_idxs: List[int],
        num_scales: int,
        is_train: bool = False,
        img_ext: str = ".jpg",
        load_depth: bool = False,
        load_mask: bool = False,
        seed: int = 0,
    ):
        self.data_path = data_path
        self.filenames = filenames
        self.height = height
        self.width = width
        self.cam_name = cam_name
        self.img_type = img_type
        self.frame_idxs = list(frame_idxs)
        self.num_scales = num_scales
        self.is_train = is_train
        self.img_ext = img_ext
        self.load_depth = load_depth
        self.load_mask = load_mask
        self.jitter = ColorJitter()
        self.aug_freq = 0.5
        self._base_seed = seed

    def __len__(self):
        return len(self.filenames)

    # -- per-dataset hooks ----------------------------------------------------
    def get_img_path(self, folder, frame_index, side):
        raise NotImplementedError

    def get_color(self, folder, frame_index, side, do_flip) -> Image.Image:
        raise NotImplementedError

    def get_depth(self, folder, frame_index, side, do_flip) -> np.ndarray:
        raise NotImplementedError

    def get_mask(self, folder, frame_index, side, do_flip):
        raise NotImplementedError

    def get_intrinsic(self, folder) -> np.ndarray:
        raise NotImplementedError

    def get_gt_dim(self, folder, frame_index, side):
        raise NotImplementedError

    def get_timestep(self, folder, frame_index, offset):
        return 1.0

    # -- item assembly --------------------------------------------------------
    def parse_line(self, index: int):
        line = self.filenames[index].split()
        folder = line[0]
        frame_index = int(line[1])
        side = line[2] if len(line) == 3 else "l"
        return folder, frame_index, side

    def __getitem__(self, index: int) -> Dict:
        return self.get_item(index, rng=np.random.RandomState(
            (self._base_seed * 1_000_003 + index) % (2 ** 31)
        ))

    def get_item(self, index: int, rng: Optional[np.random.RandomState] = None) -> Dict:
        if rng is None:
            rng = np.random.RandomState()
        inputs: Dict = {}

        do_flip = self.is_train and rng.rand() > 0.5
        folder, frame_index, side = self.parse_line(index)

        do_jitter = self.is_train and rng.rand() < self.aug_freq
        color_aug = self.jitter.sample(rng) if do_jitter else (lambda x: x)

        colors = self._load_colors(folder, frame_index, side, do_flip)
        for i in self.frame_idxs:
            arr = colors[i]  # (H, W, 3) float32 in [0, 1]
            inputs[("color", i, 0)] = arr
            inputs[("color_aug", i, 0)] = color_aug(arr).astype(np.float32)
            inputs[("ts", i)] = np.float32(self.get_timestep(folder, frame_index, i))

        gt_h, gt_w = self.get_gt_dim(folder, frame_index, side)
        inputs["gt_dim"] = np.array([gt_h, gt_w], dtype=np.int32)

        for scale in range(self.num_scales):
            K = self.get_intrinsic(folder).copy()
            K[0, :] *= self.width // (2 ** scale)
            K[1, :] *= self.height // (2 ** scale)
            inputs[("K", scale)] = K.astype(np.float32)
            inputs[("inv_K", scale)] = np.linalg.pinv(K).astype(np.float32)

        if self.load_depth:
            pts = self.get_depth(folder, frame_index, side, do_flip).astype(np.float32)
            n = min(pts.shape[0], MAX_LIDAR_NUM)
            depth = np.zeros((MAX_LIDAR_NUM, 3), np.float32)
            valid = np.zeros((MAX_LIDAR_NUM,), np.float32)
            depth[:n] = pts[:n]
            valid[:n] = 1.0
            inputs["depth_gt"] = depth
            inputs["depth_valid"] = valid

        if self.load_mask:
            sem_mask, mot_mask = self.get_mask(folder, frame_index, side, do_flip)
            inputs["sem_mask"] = sem_mask.astype(np.uint8)
            inputs["mot_mask"] = mot_mask.astype(np.uint8)

        inputs["index"] = np.int32(index)
        return inputs

    def clamp_frame_index(self, frame_index: int) -> int:
        """Per-dataset sequence-start clamping hook (KITTI maps -1 -> 0)."""
        return frame_index

    def _load_colors(self, folder, frame_index, side, do_flip):
        """Load all triplet frames -> {frame_offset: (H, W, 3) float32}.

        Prefers the native C++ data plane (fused decode + PIL-parity bicubic
        resize + flip, GIL-free) where its library builds; else PIL per frame.
        """
        from dynamo_depth_torch.data import native

        if native.available():
            paths = [
                self.get_img_path(folder, self.clamp_frame_index(frame_index + i), side)
                for i in self.frame_idxs
            ]
            try:
                arr = native.decode_resize_batch(
                    paths, self.height, self.width,
                    [do_flip] * len(paths), n_threads=1,
                )
                _count_decodes("native", len(paths))
                return {i: arr[k] for k, i in enumerate(self.frame_idxs)}
            except RuntimeError:
                pass  # e.g. unreadable file: surface via the PIL path's error

        out = {}
        for i in self.frame_idxs:
            img = self.get_color(folder, frame_index + i, side, do_flip)
            if img.size != (self.width, self.height):
                img = img.resize((self.width, self.height), Image.BICUBIC)
            out[i] = np.asarray(img, dtype=np.float32) / 255.0
        _count_decodes("pil", len(out))
        return out

    # -- shared helpers -------------------------------------------------------
    def _seg_cam_dir(self, folder, *parts):
        return osp.join(self.data_path, folder, self.cam_name, *parts)
