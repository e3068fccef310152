"""The inputs of a run, made on the device from ``--seed``: the weights,
a ring of distinct synthetic batches, and the generator the step draws its
drop-path masks and RANSAC hypotheses from. The same seed gives the same
inputs; the program and the reference are handed the same ones.
"""

from __future__ import annotations

import hashlib
import math

import torch

# Normalized KITTI intrinsics of the synthetic batch (the program's
# ``training/synthetic.py::K_NORM``): scale s multiplies the first row by
# the width and the second by the height, both divided by 2**s.
K_NORM = ((0.58, 0.0, 0.5, 0.0), (0.0, 1.92, 0.5, 0.0), (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0))
# The std of a standard normal truncated to [-2, 2].
_TRUNCATED_STD = 0.87962566103423978
LAYER_SCALE_INIT = 1e-6


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one kind of draw, from the run's seed (any whole
    number, negative or beyond 64 bits included)."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{what}".encode()).digest()[:8], "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, what))


def _fan_in(shape) -> int:
    return math.prod(shape[1:])


@torch.no_grad()
def draw_weights(state_dict: dict, seed: int, device) -> dict:
    """Weights for a state dict of this model family, drawn on ``device``
    from the seed, as the JAX package initialises its counterparts: conv and
    dense kernels a normal of variance ``1 / fan_in`` truncated at two of its
    stds, biases and norm shifts 0, norm scales 1, LiteMono's layer scales
    ``gamma``/``gamma_xca`` 1e-6, the XCA temperature 1, BatchNorm running
    means 0 and variances 1. The kernels come from one draw. ``state_dict``
    gives only the names and shapes (it may live on the meta device)."""
    kernels = [(k, v.shape) for k, v in state_dict.items() if v.dim() >= 2 and k.endswith("weight")]
    total = sum(math.prod(shape) for _, shape in kernels)
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    out, at = {}, 0
    for key, shape in kernels:
        n = math.prod(shape)
        std = math.sqrt(1.0 / _fan_in(shape)) / _TRUNCATED_STD
        out[key] = (flat[at:at + n].clamp_(-2.0, 2.0) * std).reshape(shape)
        at += n
    for key, value in state_dict.items():
        if key in out:
            continue
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("gamma", "gamma_xca"):
            out[key] = torch.full(value.shape, LAYER_SCALE_INIT, device=device)
        elif leaf == "temperature" or (leaf == "weight" and value.dim() == 1):
            out[key] = torch.ones(value.shape, device=device)
        elif leaf == "bias":
            out[key] = torch.zeros(value.shape, device=device)
        elif leaf == "running_mean":
            out[key] = torch.zeros(value.shape, device=device)
        elif leaf == "running_var":
            out[key] = torch.ones(value.shape, device=device)
        elif leaf == "num_batches_tracked":
            out[key] = torch.zeros((), dtype=torch.long, device=device)
        else:
            raise ValueError(f"no rule draws {key} {tuple(value.shape)}")
    return out


def intrinsics(height: int, width: int, scale: int):
    """(K, inv_K) of one scale, 4x4 float32 on the CPU."""
    K = torch.tensor(K_NORM, dtype=torch.float64)
    K[0] *= width // (2 ** scale)
    K[1] *= height // (2 ** scale)
    return K.float(), torch.linalg.inv(K).float()


@torch.no_grad()
def make_batches(options: dict, count: int, seed: int, device) -> list:
    """``count`` distinct synthetic batches, the program's ``synthetic_batch``
    drawn on the device: every frame's ``color_aug`` and ``color`` uniform in
    [0, 1) as contiguous NCHW images, ``ts`` ones, and ``K`` / ``inv_K`` per
    scale. One uniform draw per batch."""
    B, H, W = options["batch_size"], options["height"], options["width"]
    frames = list(options["frame_ids"])
    g = generator(seed, "batches", device)
    batches = []
    for _ in range(count):
        images = torch.rand((2 * len(frames), B, 3, H, W), generator=g, device=device)
        batch = {}
        for i, f in enumerate(frames):
            batch[("color_aug", f, 0)] = images[i]
            batch[("color", f, 0)] = images[len(frames) + i]
            batch[("ts", f)] = torch.ones((B,), device=device)
        for s in options["scales"]:
            K, inv_K = intrinsics(H, W, s)
            batch[("K", s)] = K.to(device).expand(B, 4, 4).contiguous()
            batch[("inv_K", s)] = inv_K.to(device).expand(B, 4, 4).contiguous()
        batches.append(batch)
    return batches
