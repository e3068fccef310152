"""Training entry point of the port (the JAX package's ``train.py``).

    python -m dynamo_depth_torch.train -d kitti -n NAME [the flags of train.py]
    torchrun --nproc_per_node N -m dynamo_depth_torch.train -d kitti -n NAME [flags]

Runs the four-phase curriculum on the card and writes a checkpoint folder
per phase and epoch under ``<log_dir>/<NAME>/models/``. Under torchrun each
of the N processes trains on its own card (``LOCAL_RANK``) with
``--batch_size`` rows of every global batch, over NCCL (``parallel/dist.py``);
``--num_devices`` is then 0 or N.
"""

from dynamo_depth_torch.config import parse_config
from dynamo_depth_torch.parallel import init_distributed, world_size
from dynamo_depth_torch.training.trainer import Trainer


def main(argv=None, device=None) -> Trainer:
    """Parse ``argv`` (default: the command line), join the launch's process
    group if there is one, train, and return the trainer. ``device="cpu"``
    runs on the CPU (over gloo under a launch); the default is the card."""
    cfg = parse_config(argv)
    init_distributed(device)
    cfg.local_world_size = world_size()
    trainer = Trainer(cfg, device=device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
