"""The ImageNet backbones and the released checkpoints (port of
``dynamo_depth_tpu/models/convert.py:274-358``).

``weights_init="pretrained"`` starts the encoders from ImageNet files placed
under ``./ckpt`` (the reference downloads them; nothing here fetches them):

- the torchvision ResNet file (``BACKBONE_FILES["resnet18"]``), with ``fc.*``
  dropped and the keys prefixed with ``encoder.``, loads into ``pose_enc``
  and ``motion_enc`` (conv1 widened to 2 and 3 frames by
  :func:`widen_conv1`) and, for monodepthv2, ``depth_enc``;
- the Lite-Mono-8M file's ``["model"]``, without its final ``norm*`` keys,
  loads into LiteMono's ``depth_enc``.

A missing file leaves the random init (``models/init.py``) and says so. The
port's state-dict keys are the reference's, so these are plain
``load_state_dict`` calls. :data:`MODEL_ZOO` names the released checkpoints
that ``-l ckpt/<name>`` fetches (``Trainer.load_model``).
"""

from __future__ import annotations

import argparse
import os.path as osp

import numpy as np
import torch
import torch.nn as nn

from dynamo_depth_torch.models.convert import flax_entries

# Released checkpoint zoo (model.py:49-56): folder name -> Google Drive id.
MODEL_ZOO = {
    "ckpt/K_Dynamo-Depth_MD2": "1SLQcCQplfAtqeWUD4TQc42aGpevViTGX",
    "ckpt/K_Dynamo-Depth": "1b1kwxqUquFbSMU9WLAr6_pIbj1HxoWLJ",
    "ckpt/N_Dynamo-Depth_MD2": "1t0Z_2hD0raAi4vDK_VZFXIcwcTFx0elU",
    "ckpt/N_Dynamo-Depth": "1oqQVFyGxo_SxclpinrBlwGSE1gEfVAZY",
    "ckpt/W_Dynamo-Depth_MD2": None,  # Waymo license: request access (README)
    "ckpt/W_Dynamo-Depth": None,
}

# ImageNet backbone checkpoints the reference auto-downloads
# (resnet_encoder.py:46-49, depth_encoder.py:313).
BACKBONE_FILES = {
    "resnet18": "resnet18-f37072fd.pth",
    "resnet50": "resnet50-0676ba61.pth",
    "litemono": "lite-mono-8m-pretrain.pth",
}


def widen_conv1(weight: torch.Tensor, num_input_images: int, rng: np.random.RandomState) -> torch.Tensor:
    """A 3-channel pretrained conv1 weight (out, 3, kh, kw) replicated across
    ``num_input_images`` stacked frames and scaled by 1/num_images, over a
    kaiming-normal filler (resnet_encoder.py:85-92). The filler is drawn as
    the JAX package draws it, in flax's (kh, kw, 3n, out) layout, so the
    result equals its kernel bit for bit after the transpose."""
    kernel = weight.detach().cpu().numpy().transpose(2, 3, 1, 0)  # OIHW -> HWIO
    kh, kw, _, out = kernel.shape
    fan_out = kh * kw * out
    w = rng.randn(kh, kw, 3 * num_input_images, out).astype(np.float32) * np.sqrt(2.0 / fan_out)
    for i in range(num_input_images):
        w[:, :, 3 * i : 3 * i + 3, :] = kernel / num_input_images
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def load_pretrained_backbones(model: nn.Module, cfg, ckpt_dir: str = "./ckpt", verbose: bool = True,
                              seed: int = 0) -> nn.Module:
    """Load the ImageNet backbones under ``ckpt_dir`` into the encoders of
    the port ``model`` in place, as the JAX package's
    ``load_pretrained_backbones`` does (the same messages, the same conv1
    filler from ``np.random.RandomState(seed)``: pose first, then motion).
    A missing file keeps the encoders' random init. Returns ``model``."""
    rng = np.random.RandomState(seed)
    resnet_file = osp.join(ckpt_dir, BACKBONE_FILES[f"resnet{cfg.encoder_num_layers}"]) \
        if cfg.encoder_num_layers in (18, 50) else None

    resnet_sd = None
    if resnet_file and osp.exists(resnet_file):
        raw = torch.load(resnet_file, map_location="cpu", weights_only=True)
        resnet_sd = {f"encoder.{k}": v for k, v in raw.items() if not k.startswith("fc.")}
    elif verbose:
        print(f"|- pretrained resnet weights not found under {ckpt_dir} - "
              "encoders keep random init")

    def resnet_into(module_name, num_images):
        if resnet_sd is None:
            return
        sd = dict(resnet_sd)
        if num_images > 1:
            sd["encoder.conv1.weight"] = widen_conv1(sd["encoder.conv1.weight"], num_images, rng)
        getattr(model, module_name).load_state_dict(sd)
        if verbose:
            print(f"|- pretrained {module_name} ({num_images} frame(s)) loaded")

    resnet_into("pose_enc", 2)
    resnet_into("motion_enc", 3)

    if cfg.depth_model == "monodepthv2":
        resnet_into("depth_enc", 1)
    else:
        lm_file = osp.join(ckpt_dir, BACKBONE_FILES["litemono"])
        if osp.exists(lm_file):
            # ConvNeXt-style ImageNet training scripts store their argparse
            # arguments beside "model".
            with torch.serialization.safe_globals([argparse.Namespace]):
                raw = torch.load(lm_file, map_location="cpu", weights_only=True)["model"]
            encoder = model.depth_enc
            # The reference drops the classifier-head 'norm.*' keys
            # (depth_encoder.py:390); other keys of the classifier have no
            # place in the encoder, and the JAX package reads none of them.
            own = encoder.state_dict()
            sd = {k: v for k, v in raw.items() if not k.startswith("norm") and k in own}
            missing = [key for key, *_ in flax_entries(encoder, "depth_enc") if key not in sd]
            if missing:
                raise KeyError(f"{lm_file} lacks {missing[:5]} ({len(missing)} entries of the encoder)")
            encoder.load_state_dict(sd, strict=False)
            if verbose:
                print("|- pretrained lite-mono-8m depth encoder loaded")
        elif verbose:
            print(f"|- {lm_file} not found - litemono depth encoder keeps random init")
    return model
