"""Module-keyed checkpoints in the reference's layout (reference
``networks/model.py:163-230``, ``Trainer.py:700-707``).

One folder per save, ``<log_dir>/<model_name>/models/<phase>_<epoch:02>/``,
with one ``<module>.pth`` state dict per module (depth_enc, depth_dec,
pose_enc, pose_dec, motion_enc, motion_dec, motion_mask) and the optimizer's
state dict as ``adam.pth``. Encoder files also carry the ``height`` and
``width`` the model was trained at; loading warns when they differ from the
run's. These are the files the reference writes and the JAX package's
``convert_torch_checkpoint`` reads. Loading skips a missing module with a
warning and, where keys or shapes differ, loads the entries that match
(model.py:198-208). Every file is written to a temporary name and renamed,
so a crash mid-save leaves an earlier checkpoint whole.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import torch

from dynamo_depth_torch.models.model import MODULE_NAMES
from dynamo_depth_torch.utils.io import join_dir

_STAMP = ("height", "width")


def _is_encoder(module: str) -> bool:
    return module.endswith("_enc")


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_model(model: torch.nn.Module, folder: str, *, height: int, width: int, verbose: bool = False) -> None:
    """Write one ``<module>.pth`` per module of ``model`` into ``folder``."""
    join_dir(folder)
    for module in MODULE_NAMES:
        sd = {k: v.detach().cpu() for k, v in getattr(model, module).state_dict().items()}
        if _is_encoder(module):
            sd["height"], sd["width"] = height, width
        _atomic_save(sd, osp.join(folder, f"{module}.pth"))
    if verbose:
        print(f"Saved model to {folder}")


def save_opt_state(optimizer: torch.optim.Optimizer, folder: str) -> None:
    _atomic_save(optimizer.state_dict(), osp.join(folder, "adam.pth"))


def load_opt_state(optimizer: torch.optim.Optimizer, folder: str) -> bool:
    """Restore ``adam.pth`` into ``optimizer``; False when the folder has
    none. Raises ValueError when it holds another set of parameters."""
    path = osp.join(folder, "adam.pth")
    if not osp.exists(path):
        return False
    optimizer.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return True


def load_model(model: torch.nn.Module, folder: str, *, height: Optional[int] = None,
               width: Optional[int] = None, verbose: bool = True) -> None:
    """Load every ``<module>.pth`` of ``folder`` into ``model`` in place."""
    for module in MODULE_NAMES:
        path = osp.join(folder, f"{module}.pth")
        if not osp.exists(path):
            if verbose:
                print(f"|- Loading {module} weights... FAILED :: Path {path} not found")
            continue
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        stamp = {k: loaded.pop(k) for k in _STAMP if k in loaded}
        if verbose and stamp and height is not None and (stamp.get("height"), stamp.get("width")) != (height, width):
            print(f"|- === WARNING: opt ({height},{width}) != loaded ({stamp.get('height')},{stamp.get('width')})")
        target = getattr(model, module)
        own = target.state_dict()
        if loaded.keys() == own.keys() and all(loaded[k].shape == own[k].shape for k in own):
            target.load_state_dict(loaded)
            if verbose:
                print(f"|- Loading {module} weights...")
            continue
        matched = {k: v for k, v in loaded.items() if k in own and v.shape == own[k].shape}
        own.update(matched)
        target.load_state_dict(own)
        if verbose:
            print(f"|- Loading {module} weights... FAILED :: mismatch - loading matched parameters.")
            print(f"|- Loading {module} weights... PARTIAL :: {len(matched)} matched, {len(loaded) - len(matched)} skipped")
