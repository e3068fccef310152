"""The evaluation CLIs of the port (the JAX package's ``eval/``): depth,
motion segmentation, odometry and visualisation, each
``python -m dynamo_depth_torch.eval.<name>`` with the same flags, writing
the same files under ``<eval_dir>/<model>_<dataset>/``."""
