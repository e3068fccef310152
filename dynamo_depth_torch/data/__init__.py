"""Host-side input pipeline (the port's copy of ``dynamo_depth_tpu.data``).

Numpy/PIL triplet loading with flip + shared ColorJitter augmentation, the
intrinsics pyramid, padded LiDAR point lists and motion masks, feeding a
prefetching batch iterator of numpy batches. The items and batches equal the
JAX package's exactly; the trainer moves them to the device.
"""

from dynamo_depth_torch.data.base import BaseDataset  # noqa: F401
from dynamo_depth_torch.data.kitti import KITTIDataset  # noqa: F401
from dynamo_depth_torch.data.waymo import WaymoDataset  # noqa: F401
from dynamo_depth_torch.data.nuscenes import nuScenesDataset  # noqa: F401
from dynamo_depth_torch.data.loader import BatchLoader, make_dataset  # noqa: F401
from dynamo_depth_torch.data.splits import read_split, split_exists  # noqa: F401

DATASETS = {
    "kitti": KITTIDataset,
    "waymo": WaymoDataset,
    "nuscenes": nuScenesDataset,
}
