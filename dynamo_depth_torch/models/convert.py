"""Carry the JAX package's weights into the port.

:func:`load_jax_variables` takes the flax ``params`` and ``batch_stats``
trees of a ``dynamo_depth_tpu`` ``DynamoModel`` as numpy arrays and copies
them into a port :class:`~dynamo_depth_torch.models.model.DynamoModel`;
:func:`module_to_jax_variables` gives one port module's trees back. The
port's modules carry the reference's torch state-dict keys, so this is the
inverse of the JAX package's torch -> flax converter
(``dynamo_depth_tpu/models/convert.py:86-226``), kept here as the port's own
copy of that mapping:

- conv kernel (kH, kW, I, O) -> weight (O, I, kH, kW)
- dense kernel (I, O)        -> weight (O, I)
- BatchNorm scale/bias + batch_stats mean/var -> weight/bias + running_mean/running_var
- LayerNorm scale/bias       -> weight/bias
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from dynamo_depth_torch.models.litemono import DilatedConv
from dynamo_depth_torch.models.model import MODULE_NAMES


def _resnet_path(prefix: str) -> Optional[Tuple[str, ...]]:
    m = re.fullmatch(r"encoder\.(conv1|bn1)", prefix)
    if m:
        return (m.group(1),)
    m = re.fullmatch(r"encoder\.layer(\d+)\.(\d+)\.(conv\d|bn\d|downsample\.0|downsample\.1)", prefix)
    if m:
        leaf = {"downsample.0": "ds_conv", "downsample.1": "ds_bn"}.get(m.group(3), m.group(3))
        return (f"layer{m.group(1)}_{m.group(2)}", leaf)
    return None


def _litemono_path(prefix: str) -> Optional[Tuple[str, ...]]:
    m = re.fullmatch(r"downsample_layers\.0\.(\d)\.(conv|bn_gelu\.bn)", prefix)
    if m:
        return (f"stem1_{m.group(1)}", "conv" if m.group(2) == "conv" else "bn")
    if prefix == "stem2.0.conv":
        return ("stem2",)
    m = re.fullmatch(r"downsample_layers\.([12])\.0\.conv", prefix)
    if m:
        return (f"downsample{m.group(1)}",)
    m = re.fullmatch(r"stages\.(\d+)\.(\d+)(?:\.(.*))?", prefix)
    if m:
        block = (f"stage{m.group(1)}_block{m.group(2)}",)
        rest = m.group(3)
        if rest is None:
            return block
        return block + tuple({"ddwconv.conv": "ddwconv"}.get(rest, rest).split("."))
    return None


def _lite_depth_decoder_path(prefix: str, scales) -> Optional[Tuple[str, ...]]:
    m = re.fullmatch(r"decoder\.(\d+)\.conv(\.conv)?", prefix)
    if not m:
        return None
    idx = int(m.group(1))
    if idx < 6:
        return (f"upconv_{2 - idx // 2}_{idx % 2}", "conv", "conv")
    return (f"dispconv_{scales[idx - 6]}", "conv")


def _depth_decoder_path(prefix: str) -> Optional[Tuple[str, ...]]:
    m = re.fullmatch(r"(upconv_\d+_\d+)\.conv\.conv", prefix)
    if m:
        return (m.group(1), "conv", "conv")
    m = re.fullmatch(r"(dispconv_\d+)\.conv", prefix)
    return (m.group(1), "conv") if m else None


def _pose_decoder_path(prefix: str) -> Optional[Tuple[str, ...]]:
    if prefix == "squeeze":
        return ("squeeze",)
    m = re.fullmatch(r"pose(\d)", prefix)
    return (f"pose_{m.group(1)}",) if m else None


def _motion_decoder_path(prefix: str) -> Optional[Tuple[str, ...]]:
    if prefix == "_residual_translation":
        return ("residual_translation",)
    m = re.fullmatch(r"refine_motion_conv(\d+)\.(\d)", prefix)
    if m:
        return (f"refine_conv{m.group(1)}_{m.group(2)}",)
    m = re.fullmatch(r"refine_motion_redu(\d+)", prefix)
    return (f"refine_redu{m.group(1)}",) if m else None


def flax_module_path(module_name: str, prefix: str, scales=(0, 1, 2),
                     depth_model: str = "litemono") -> Optional[Tuple[str, ...]]:
    """Flax path of the port submodule ``prefix`` (a state-dict key without
    its leaf) inside module ``module_name`` of a ``depth_model`` network."""
    monodepthv2 = depth_model == "monodepthv2"
    if module_name in ("pose_enc", "motion_enc") or (module_name == "depth_enc" and monodepthv2):
        return _resnet_path(prefix)
    if module_name == "depth_enc":
        return _litemono_path(prefix)
    if module_name == "depth_dec":
        return _depth_decoder_path(prefix) if monodepthv2 else _lite_depth_decoder_path(prefix, tuple(scales))
    if module_name == "pose_dec":
        return _pose_decoder_path(prefix)
    return _motion_decoder_path(prefix)


def _leaf_spec(module: nn.Module, name: str):
    """(collection, flax leaf name, axes that take the flax array to torch's
    layout or None) for one state-dict entry; None for entries flax does not
    keep (BatchNorm's num_batches_tracked)."""
    if isinstance(module, nn.Conv2d):
        return ("params", "kernel", (3, 2, 0, 1)) if name == "weight" else ("params", "bias", None)
    if isinstance(module, nn.Linear):
        return ("params", "kernel", (1, 0)) if name == "weight" else ("params", "bias", None)
    if isinstance(module, nn.BatchNorm2d):
        return {
            "weight": ("params", "scale", None),
            "bias": ("params", "bias", None),
            "running_mean": ("batch_stats", "mean", None),
            "running_var": ("batch_stats", "var", None),
        }.get(name)
    if isinstance(module, nn.LayerNorm):
        return "params", {"weight": "scale", "bias": "bias"}[name], None
    return "params", name, None  # raw parameters: gamma, gamma_xca, temperature


def _get(tree: Dict, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def flax_entries(module: nn.Module, module_name: str, scales=(0, 1, 2), depth_model: str = "litemono"):
    """(state-dict key, tensor, collection, flax path, axes) of each entry of
    ``module`` that flax keeps: ``axes`` take the flax array to torch's
    layout (None: the same layout). Raises if an entry has no flax
    counterpart. The dilated-conv blocks' ``norm`` (unused in forward,
    absent in flax) is left out."""
    modules = dict(module.named_modules())
    for key, tensor in module.state_dict().items():
        prefix, name = key.rsplit(".", 1)
        parent = modules.get(prefix.rsplit(".", 1)[0]) if "." in prefix else None
        if isinstance(parent, DilatedConv) and prefix.endswith(".norm"):
            continue
        spec = _leaf_spec(modules[prefix], name)
        if spec is None:
            continue
        collection, leaf, axes = spec
        path = flax_module_path(module_name, prefix, scales, depth_model)
        if path is None:
            raise KeyError(f"{module_name}.{key} has no flax counterpart")
        yield key, tensor, collection, path + (leaf,), axes


def flax_to_torch(value, axes) -> np.ndarray:
    """A flax leaf as a float32 array in torch's layout."""
    value = np.array(value, np.float32)
    return np.ascontiguousarray(value if axes is None else np.transpose(value, axes))


def torch_to_flax(tensor: torch.Tensor, axes) -> np.ndarray:
    """A torch tensor as a float32 array in flax's layout (the inverse of
    :func:`flax_to_torch`)."""
    value = tensor.detach().cpu().float().numpy()
    return np.ascontiguousarray(value if axes is None else np.transpose(value, np.argsort(axes)))


def load_module_variables(module: nn.Module, module_name: str, params: Dict, batch_stats: Dict,
                          scales=(0, 1, 2), depth_model: str = "litemono") -> nn.Module:
    """Copy one module's flax ``params`` / ``batch_stats`` subtrees into the
    port ``module`` (one of ``MODULE_NAMES``) in place; returns it.

    Raises if a port tensor has no flax counterpart or the shapes differ. The
    dilated-conv blocks' ``norm`` (unused in forward, absent in flax) keeps
    its initial values."""
    trees = {"params": params, "batch_stats": batch_stats or {}}
    with torch.no_grad():
        for key, tensor, collection, path, axes in flax_entries(module, module_name, scales, depth_model):
            value = flax_to_torch(_get(trees[collection], path), axes)
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{module_name}.{key}: flax {path} has shape {value.shape}, port {tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(value))
    return module


def module_to_jax_variables(module: nn.Module, module_name: str, depth_model: str = "litemono",
                            scales=(0, 1, 2)) -> Tuple[Dict, Dict]:
    """The flax ``(params, batch_stats)`` trees of one port module, as
    float32 numpy (the inverse of :func:`load_module_variables`, exact:
    only transposes); ``batch_stats`` is empty for a module without
    BatchNorm."""
    trees = {"params": {}, "batch_stats": {}}
    for _, tensor, collection, path, axes in flax_entries(module, module_name, scales, depth_model):
        _set(trees[collection], path, torch_to_flax(tensor, axes))
    return trees["params"], trees["batch_stats"]


def load_jax_variables(model: nn.Module, params: Dict, batch_stats: Dict, cfg) -> nn.Module:
    """Copy the flax ``params`` / ``batch_stats`` of a whole JAX
    ``DynamoModel`` (nested dicts of numpy arrays keyed by module name) into
    the port ``model`` in place; returns it."""
    for name in MODULE_NAMES:
        load_module_variables(getattr(model, name), name, params[name], batch_stats.get(name, {}), tuple(cfg.scales),
                              cfg.depth_model)
    return model
