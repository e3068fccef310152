"""Training entry point of the port (the JAX package's ``train.py``).

    python -m dynamo_depth_torch.train -d kitti -n NAME [the flags of train.py]

Runs the four-phase curriculum on the card and writes a checkpoint folder
per phase and epoch under ``<log_dir>/<NAME>/models/``. ``--num_devices``
above 1 is refused: multi-GPU training is not ported yet.
"""

from dynamo_depth_torch.config import parse_config
from dynamo_depth_torch.training.trainer import Trainer


def main(argv=None, device=None) -> Trainer:
    """Parse ``argv`` (default: the command line), train, and return the
    trainer. ``device="cpu"`` runs on the CPU; the default is the card."""
    trainer = Trainer(parse_config(argv), device=device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
