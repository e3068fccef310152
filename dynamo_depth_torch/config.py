"""Configuration for dynamo_depth_torch.

The port's own copy of ``dynamo_depth_tpu.config.DynamoConfig``: the same
fields, defaults and two-stage resolution order

    explicit field  >  dataset-conditional default table  >  model-conditional scales

so a config written for the JAX package parses here unchanged. Fields that
only steered TPU formulations (``image_dtype``, ``pallas_warp``,
``pallas_photometric``, ``num_devices``, ``prefetch_depth``) keep their names
so configs still parse; on the card the warp and photometric kernels are the
only path whatever they say.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


# Dataset-conditional defaults (reference options.py:274-286).
_DATASET_CONF = {
    "split": {"waymo": "waymo", "nuscenes": "nuscenes", "kitti": "eigen_zhou"},
    "height": {"waymo": 320, "nuscenes": 288, "kitti": 192},
    "width": {"waymo": 480, "nuscenes": 512, "kitti": 640},
    "cam_name": {"waymo": "FRONT", "nuscenes": "FRONT", "kitti": "image_02"},
    "train_img_type": {"waymo": "downsample", "nuscenes": "downsample", "kitti": "downsample"},
    "eval_max_depth": {"waymo": 75, "nuscenes": 75, "kitti": 80},
    "eval_img_bound": {
        "waymo": [0, 1, 0, 1],
        "nuscenes": [0, 1, 0, 1],
        # Eigen crop, same constants as monodepth2's evaluate_depth.py.
        "kitti": [0.40810811, 0.99189189, 0.03594771, 0.96405229],
    },
    "eval_img_ext": {"waymo": ".jpg", "nuscenes": ".jpg", "kitti": ".png"},
    "eval_img_type": {"waymo": "downsample", "nuscenes": "downsample", "kitti": "original"},
}


@dataclass
class DynamoConfig:
    # EXPERIMENT options
    model_name: str = "--"
    log_dir: str = "./logs"
    eval_dir: str = "./outputs"

    # SYSTEM options (reference options.py:25-41).
    cuda_ids: List[int] = field(default_factory=lambda: [0])
    local_rank: int = 0
    ddp: bool = False
    num_workers: int = 2

    # DATASET options
    dataset: str = "waymo"
    data_path: Optional[str] = None
    split: Optional[str] = None
    height: Optional[int] = None
    width: Optional[int] = None
    img_ext: str = ".jpg"
    cam_name: Optional[str] = None

    # LOSS weights (reference options.py:78-122)
    g_p_photo: float = 1.0
    g_d_smooth: float = 1e-3
    g_d_ground: float = 0.1
    g_c_smooth: float = 1e-3
    g_c_consistency: float = 5.0
    g_m_sparsity: float = 0.04
    g_m_smooth: float = 0.1
    weight_ramp: List[str] = field(
        default_factory=lambda: ["g_c_smooth", "g_c_consistency", "g_m_sparsity", "g_m_smooth"]
    )
    ramp_red: float = 3.0
    ssim_weight: float = 0.85
    mask_disp_thrd: float = 0.03

    # TRAINING hyperparameters (reference options.py:126-150)
    epoch_schedules: List[int] = field(default_factory=lambda: [1, 1, 5, 20])
    epoch_size: int = 8000
    batch_size: int = 3
    learning_rate: float = 1e-4
    scheduler_step_size: int = 10

    # MODEL options (reference options.py:154-173)
    depth_model: str = "litemono"
    encoder_num_layers: int = 18
    weights_init: str = "pretrained"
    scales: Optional[List[int]] = None

    # TRAINING options (reference options.py:177-194)
    frame_ids: List[int] = field(default_factory=lambda: [0, -1, 1])
    min_depth: float = 0.1
    max_depth: float = 100.0
    train_img_type: Optional[str] = None

    # Ground-plane RANSAC (reference options.py:198-213)
    gp_prior: float = 0.4
    gp_tol: float = 0.005
    gp_max_it: int = 100
    gp_np_per_it: int = 5
    # "per_batch" scores each RANSAC hypothesis against its own image;
    # "reference" reproduces the reference's batch-mixing pairing
    # (tools.py:130-133) bit-faithfully.
    gp_score_mode: str = "per_batch"

    # LOADING options
    load_ckpt: str = ""
    # Restore optimizer state from load_ckpt (the reference saves but never
    # reloads it — Trainer.py:706-707).
    resume_optim: bool = False

    # LOGGING options (reference options.py:224-242)
    log_frequency: int = 100
    no_train_vis: bool = False
    save_frequency: int = 1
    comment: str = ""
    print_opt: bool = True

    # EVAL options (reference options.py:246-268)
    eval_min_depth: float = 1e-3
    eval_max_depth: Optional[float] = None
    eval_img_bound: Optional[List[float]] = None
    eval_img_ext: Optional[str] = None
    eval_img_type: Optional[str] = None

    # --- Fields the JAX package added (kept so its configs parse) ---
    # Number of data-parallel shards (the JAX package's mesh size).
    num_devices: int = 0
    # Compute dtype for network forward/backward ("bfloat16" or "float32").
    # Params and optimizer state are always float32. The port runs float32.
    compute_dtype: str = "float32"
    # Storage dtype of the warp operand in the JAX package; the port's warp
    # kernel always reads float32.
    image_dtype: str = "auto"
    # Host pipeline: batches to keep in flight on device.
    prefetch_depth: int = 2
    # Seed for every RNG (numpy, torch generators).
    seed: int = 0
    # Capture profiler traces into <log_dir>/traces when set.
    profile: bool = False
    # Selected the TPU's Pallas photometric / warp kernels in the JAX package.
    # On the card the port's CUDA kernels are the only path either way.
    pallas_photometric: bool = False
    pallas_warp: bool = False
    # Set in multi-process mode; mirrors reference local_world_size.
    local_world_size: int = 1

    def __post_init__(self):
        self.resolve()

    def resolve(self) -> "DynamoConfig":
        """Apply dataset-/model-conditional defaults (options.py:270-303)."""
        if self.scales is None:
            # monodepthv2 supervises 4 scales, litemono 3 (options.py:288-294).
            self.scales = [0, 1, 2, 3] if self.depth_model == "monodepthv2" else [0, 1, 2]
        if self.data_path is None:
            self.data_path = f"data_dir/{self.dataset}/"
        for k, table in _DATASET_CONF.items():
            if getattr(self, k) is None:
                setattr(self, k, table[self.dataset])
        return self

    def validate(self) -> "DynamoConfig":
        if self.height % 32 or self.width % 32:
            raise ValueError(f"height(={self.height}) and width(={self.width}) must be multiples of 32")
        if self.frame_ids[0] != 0:
            raise ValueError(f"frame_ids(={self.frame_ids}) must start with 0")
        if len(self.epoch_schedules) != 4 or any(e < 0 for e in self.epoch_schedules):
            raise ValueError(f"epoch_schedules(={self.epoch_schedules}) must be length=4 and non-negative")
        return self
