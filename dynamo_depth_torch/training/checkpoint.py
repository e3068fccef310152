"""Module-keyed checkpoints in the reference's layout (reference
``networks/model.py:163-230``, ``Trainer.py:700-707``), and the JAX
package's ``.msgpack`` folders.

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

A folder the JAX package wrote (``dynamo_depth_tpu/training/checkpoint.py``:
``<module>.msgpack`` holding ``{"params", "batch_stats"}`` in flax layout,
``meta.json`` with the height and width, ``adam.msgpack`` with optax's
state) loads too, by the JAX package's precedence
(``dynamo_depth_tpu/training/trainer.py:615-626``): a folder with ``.pth``
files and no ``.msgpack`` file is the reference's layout, any other folder
the JAX package's. :func:`save_jax_folder` writes such a folder from the
port's model and optimizer; the port's own checkpoints stay ``.pth``.
"""

from __future__ import annotations

import glob
import json
import os
import os.path as osp
from typing import Dict, Optional

import numpy as np
import torch

from dynamo_depth_torch.models.convert import flax_entries, flax_to_torch, load_module_variables, \
    module_to_jax_variables, torch_to_flax
from dynamo_depth_torch.models.model import MODULE_NAMES
from dynamo_depth_torch.utils import msgpack
from dynamo_depth_torch.utils.io import join_dir

_STAMP = ("height", "width")
_COLLECTIONS = ("params", "batch_stats")


def _is_encoder(module: str) -> bool:
    return module.endswith("_enc")


def _atomic_write(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _atomic_save(obj, path: str) -> None:
    _atomic_write(path, lambda tmp: torch.save(obj, tmp))


def _atomic_bytes(data: bytes, path: str) -> None:
    def write(tmp):
        with open(tmp, "wb") as f:
            f.write(data)

    _atomic_write(path, write)


def is_jax_folder(folder: str) -> bool:
    """True unless ``folder`` holds ``.pth`` files and no ``.msgpack`` file."""
    return not (glob.glob(osp.join(folder, "*.pth")) and not glob.glob(osp.join(folder, "*.msgpack")))


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


def load_opt_state(optimizer: torch.optim.Optimizer, folder: str, model: torch.nn.Module) -> bool:
    """Restore the folder's optimizer state into ``optimizer``: ``adam.pth``,
    or in a JAX folder ``adam.msgpack`` (laid out by the flax names of
    ``model``, the model the optimizer's parameters belong to). False when
    the folder has neither. Raises ValueError when it holds another set of
    parameters."""
    if is_jax_folder(folder):
        path = osp.join(folder, "adam.msgpack")
        if not osp.exists(path):
            return False
        with open(path, "rb") as f:
            optimizer.load_state_dict(_optax_to_torch(msgpack.restore(f.read()), optimizer, model))
        return True
    path = osp.join(folder, "adam.pth")
    if not osp.exists(path):
        return False
    optimizer.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return True


def load_model(model: torch.nn.Module, folder: str, *, height: Optional[int] = None,
               width: Optional[int] = None, verbose: bool = True) -> None:
    """Load every module file of ``folder`` into ``model`` in place: the
    ``.pth`` files, or those of a JAX folder (:func:`is_jax_folder`)."""
    if is_jax_folder(folder):
        _load_jax_model(model, folder, height=height, width=width, verbose=verbose)
        return
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


# ---------------------------------------------------------------- JAX folders


def _flatten(tree, prefix=()) -> Dict:
    """Leaves of a nested dict by key path (flax's ``flatten_dict``)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, prefix + (k,)))
    return out


def _unflatten(flat: Dict) -> Dict:
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _module_trees(model: torch.nn.Module, module: str) -> Dict:
    """One module's flax trees, the collections it has (the JAX package's
    ``_module_tree``)."""
    params, stats = module_to_jax_variables(getattr(model, module), module, model.depth_model, model.scales)
    return {col: tree for col, tree in zip(_COLLECTIONS, (params, stats)) if tree}


def _load_jax_model(model, folder, *, height, width, verbose) -> None:
    """The JAX package's ``checkpoint.load_model``: a missing module is
    skipped; a file whose tree lacks a leaf of the module's, or holds one of
    another shape, loads the leaves whose path and shape match."""
    meta_path = osp.join(folder, "meta.json")
    if osp.exists(meta_path) and height is not None:
        with open(meta_path) as f:
            meta = json.load(f)
        if (meta.get("height"), meta.get("width")) != (height, width) and verbose:
            print(f"|- === WARNING: opt ({height},{width}) != loaded ({meta.get('height')},{meta.get('width')})")
    for module in MODULE_NAMES:
        path = osp.join(folder, f"{module}.msgpack")
        if not osp.exists(path):
            if verbose:
                print(f"|- Loading {module} weights... FAILED :: Path {path} not found")
            continue
        with open(path, "rb") as f:
            raw = msgpack.restore(f.read())
        template = _module_trees(model, module)
        own, got = _flatten(template), _flatten(raw)
        if all(k in got and np.shape(got[k]) == np.shape(v) for k, v in own.items()):
            if verbose:
                print(f"|- Loading {module} weights...")
            own = {k: got[k] for k in own}
        else:
            if verbose:
                print(f"|- Loading {module} weights... FAILED :: mismatch - loading matched parameters.")
            for col in template:
                if not isinstance(raw.get(col), dict):
                    continue
                loaded = {(col,) + k: v for k, v in _flatten(raw[col]).items()}
                matched = {k: v for k, v in loaded.items() if k in own and np.shape(v) == np.shape(own[k])}
                own.update(matched)
                if verbose and len(matched) < len(loaded):
                    print(f"|- Loading {module} weights... PARTIAL :: {len(matched)} matched, "
                          f"{len(loaded) - len(matched)} skipped")
        trees = _unflatten(own)
        load_module_variables(getattr(model, module), module, trees["params"], trees.get("batch_stats", {}),
                              model.scales, model.depth_model)


def _param_paths(optimizer, model) -> Dict:
    """{index of a parameter in the optimizer's state dict: (module, flax
    path, axes)} for the optimizer's parameters that flax keeps (matched by
    storage: a state dict's tensors share their parameters')."""
    where = {}
    for module in MODULE_NAMES:
        for _, tensor, collection, path, axes in flax_entries(getattr(model, module), module, model.scales,
                                                              model.depth_model):
            if collection == "params":
                where[tensor.data_ptr()] = (module, path, axes)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return {i: where[p.data_ptr()] for i, p in enumerate(params) if p.data_ptr() in where}


def _optax_to_torch(state: Dict, optimizer, model) -> Dict:
    """optax's ``adam`` state under a schedule, ``{"0": {"count", "mu",
    "nu"}, "1": {"count"}}`` with ``mu`` and ``nu`` over the trainable
    modules in flax layout, as a state dict of ``optimizer``: ``mu`` ->
    ``exp_avg``, ``nu`` -> ``exp_avg_sq``, ``count`` -> ``step``."""
    try:
        adam, count = state["0"], state["0"]["count"]
        mu, nu = adam["mu"], adam["nu"]
    except (KeyError, TypeError) as e:
        raise ValueError(f"adam.msgpack does not hold optax's adam state: no {e}") from e
    params = [p for group in optimizer.param_groups for p in group["params"]]
    paths = _param_paths(optimizer, model)
    modules = sorted({m for m, _, _ in paths.values()})
    if sorted(mu) != modules or sorted(nu) != modules:
        raise ValueError(f"adam.msgpack holds the state of modules {sorted(mu)}, the optimizer trains {modules}")
    moments = {"exp_avg": _flatten(mu), "exp_avg_sq": _flatten(nu)}
    out = {}
    for i, (module, path, axes) in paths.items():
        entry = {"step": torch.tensor(float(count), dtype=torch.float32)}
        for key, flat in moments.items():
            if (module,) + path not in flat:
                raise ValueError(f"adam.msgpack has no {key} entry for {module} {'/'.join(path)}")
            entry[key] = torch.from_numpy(flax_to_torch(flat[(module,) + path], axes))
            if entry[key].shape != params[i].shape:
                raise ValueError(f"adam.msgpack's {key} of {module} {'/'.join(path)} has shape "
                                 f"{tuple(entry[key].shape)}, the parameter {tuple(params[i].shape)}")
        out[i] = entry
    return {"state": out, "param_groups": optimizer.state_dict()["param_groups"]}


def save_jax_folder(model: torch.nn.Module, folder: str, *, height: int, width: int,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Write ``model`` (and ``optimizer``'s Adam state) as the JAX package
    writes a checkpoint folder: ``<module>.msgpack``, ``meta.json`` and
    ``adam.msgpack`` (optax's ``adam`` state under a schedule; a parameter
    with no state yet gets zero moments, as optax's init gives it)."""
    join_dir(folder)
    for module in MODULE_NAMES:
        _atomic_bytes(msgpack.packb(_module_trees(model, module)), osp.join(folder, f"{module}.msgpack"))
    _atomic_bytes(json.dumps({"height": height, "width": width, "modules": MODULE_NAMES}).encode(),
                  osp.join(folder, "meta.json"))
    if optimizer is None:
        return
    params = [p for group in optimizer.param_groups for p in group["params"]]
    steps = {int(s["step"]) for s in optimizer.state.values()}
    if len(steps) > 1:
        raise ValueError(f"the optimizer's parameters are at different steps {sorted(steps)}")
    count = np.array(steps.pop() if steps else 0, np.int32)
    mu, nu = {}, {}
    for i, (module, path, axes) in _param_paths(optimizer, model).items():
        state = optimizer.state.get(params[i], {})
        for key, flat in (("exp_avg", mu), ("exp_avg_sq", nu)):
            flat[(module,) + path] = torch_to_flax(state.get(key, torch.zeros_like(params[i])), axes)
    adam = {"0": {"count": count, "mu": _unflatten(mu), "nu": _unflatten(nu)}, "1": {"count": count.copy()}}
    _atomic_bytes(msgpack.packb(adam), osp.join(folder, "adam.msgpack"))
