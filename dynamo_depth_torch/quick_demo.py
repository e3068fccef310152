"""Quick demo of the port (the JAX package's ``quick_demo.py``).

Runs checkpoint inference on the tiny nuScenes scenes and writes the
[img | disp | ego_flow | ind_flow | mask] visualisation grid to PNG files.

    python -m dynamo_depth_torch.quick_demo --load_ckpt ckpt/N_Dynamo-Depth \
        [--data_path ./assets/tiny_nuscenes/] [--out demo_out]

Runs on the card unless ``device="cpu"`` is passed to :func:`main`.
"""

import os.path as osp
import sys

from PIL import Image

from dynamo_depth_torch.config import parse_config
from dynamo_depth_torch.data.loader import collate
from dynamo_depth_torch.eval.visualize import combine_vis, get_vis
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_torch.utils.io import join_dir

DEFAULT_FILENAMES = ["scenes/scene-0099 85", "scenes/scene-0104 2"]


def main(argv=None, device=None, filenames=DEFAULT_FILENAMES):
    """Parse ``argv`` (default: the command line), visualise ``filenames``
    and write ``demo_<i>.png``. Returns the frames."""
    argv = list(sys.argv[1:] if argv is None else argv)
    out_dir = "demo_out"
    if "--out" in argv:
        i = argv.index("--out")
        out_dir = argv[i + 1]
        del argv[i : i + 2]
    if "--dataset" not in argv and "-d" not in argv:
        argv = ["--dataset", "nuscenes"] + argv

    cfg = parse_config(argv)
    cfg.num_workers = 1
    cfg.batch_size = 1
    cfg.print_opt = False
    if cfg.data_path == f"data_dir/{cfg.dataset}/":
        cfg.data_path = "./assets/tiny_nuscenes/"

    trainer = Trainer(cfg, device=device)
    dataset = trainer.get_dataset(filenames, img_type=cfg.eval_img_type)

    arrangement = [["img", "disp", "ego_flow", "ind_flow", "mask"]]
    vis_list = []
    for i in range(len(dataset)):
        batch = collate([dataset.get_item(i)])
        vis_list.append(get_vis(cfg, trainer, batch, ref_frame_id=cfg.frame_ids[1], scale=0, items=arrangement[0]))

    frames = combine_vis(vis_list, arrangement)
    join_dir(out_dir)
    for i, frame in enumerate(frames):
        path = osp.join(out_dir, f"demo_{i}.png")
        Image.fromarray(frame).save(path)
        print(f"saved {path}")
    return frames


if __name__ == "__main__":
    main()
