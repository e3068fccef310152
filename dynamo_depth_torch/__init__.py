"""dynamo_depth_torch — the PyTorch/CUDA port of dynamo_depth_tpu.

NCHW PyTorch modules for the seven Dynamo-Depth networks, view synthesis and
the loss assembly, the data pipeline, checkpoints and the four-phase
training curriculum (``python -m dynamo_depth_torch.train``). The two kernels of
the view-synthesis hot path (bilinear warp, fused SSIM+L1 photometric error)
are hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first
use; every kernel has a plain PyTorch version beside it, which a wrapper takes
only for CPU tensors.

This package imports neither jax nor dynamo_depth_tpu.
"""

from dynamo_depth_torch.config import DynamoConfig  # noqa: F401
