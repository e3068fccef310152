"""Model container bundling the seven sub-modules (reference
``networks/model.py:15-230``), NCHW.

Logical networks -> modules (model.py:36-41), with the motion encoder shared
between the complete-flow and motion-mask decoders:

    Depth   : depth_enc, depth_dec
    Pose    : pose_enc,  pose_dec
    CmpFlow : motion_enc, motion_dec
    MotMask : motion_enc, motion_mask

Forward wiring, as the JAX package has it:
- all frames are stacked into one 3B batch for the depth encoder (in train
  mode the BatchNorm batch statistics depend on that stacking);
- pose input is cat([frame_f, frame_0]) with the target last, both source
  frames batched into one 2B encoder call, and the transformation inverted;
- motion input is cat([frame_-g, frame_0, frame_+g]) (9 channels) per gap g;
  the ego-motion conditioning vector is the *detached* antisymmetric mean of
  the two pose predictions, translation first; complete-flow outputs are
  signed +-1 per temporal direction while mask outputs are shared.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from dynamo_depth_torch.models.depth_decoder import DepthDecoder, LiteDepthDecoder
from dynamo_depth_torch.models.litemono import LiteMono
from dynamo_depth_torch.models.motion_decoder import MotionDecoder
from dynamo_depth_torch.models.pose_decoder import PoseDecoder
from dynamo_depth_torch.models.resnet import ResnetEncoder
from dynamo_depth_torch.ops.geometry import transformation_from_parameters

NETWORK2MODULES = {
    "Depth": ["depth_enc", "depth_dec"],
    "Pose": ["pose_enc", "pose_dec"],
    "CmpFlow": ["motion_enc", "motion_dec"],
    "MotMask": ["motion_enc", "motion_mask"],
}

MODULE_NAMES = sorted({m for mods in NETWORK2MODULES.values() for m in mods})


def modules_for_networks(network_names: Sequence[str]) -> list:
    """Union of module names for the given logical networks (model.py:157-164)."""
    return sorted({m for n in network_names for m in NETWORK2MODULES[n]})


class DynamoModel(nn.Module):
    def __init__(self, depth_model="litemono", encoder_num_layers=18, scales=(0, 1, 2), frame_ids=(0, -1, 1),
                 drop_path_rate=0.4):
        super().__init__()
        self.depth_model = depth_model
        self.scales = tuple(scales)
        self.frame_ids = tuple(frame_ids)
        if depth_model == "monodepthv2":
            self.depth_enc = ResnetEncoder(encoder_num_layers, num_input_images=1)
            self.depth_dec = DepthDecoder(self.depth_enc.num_ch_enc, scales=self.scales)
        elif depth_model == "litemono":
            # drop_path_rate is LiteMono's stochastic depth.
            self.depth_enc = LiteMono(drop_path_rate=drop_path_rate)
            self.depth_dec = LiteDepthDecoder(self.depth_enc.num_ch_enc, scales=self.scales)
        else:
            raise ValueError(f"depth_model {depth_model!r} not recognized")
        self.pose_enc = ResnetEncoder(encoder_num_layers, num_input_images=2)
        self.pose_dec = PoseDecoder(int(self.pose_enc.num_ch_enc[-1]), num_frames_to_predict_for=2)
        self.motion_enc = ResnetEncoder(encoder_num_layers, num_input_images=3)
        # Both motion decoders refine against the pose-encoder channel spec
        # (model.py:34-35; the motion encoder shares it).
        self.motion_dec = MotionDecoder(self.pose_enc.num_ch_enc, scales=self.scales, out_dim=3)
        self.motion_mask = MotionDecoder(self.pose_enc.num_ch_enc, scales=self.scales, out_dim=1)

    def predict_depths(self, inputs, outputs, generator):
        frames = list(self.frame_ids)
        stacked = torch.cat([inputs[("color_aug", f, 0)] for f in frames], dim=0)
        features = self.depth_enc(stacked, generator) if isinstance(self.depth_enc, LiteMono) else self.depth_enc(stacked)
        disp = self.depth_dec(features)
        for (name, s), v in disp.items():
            for f, p in zip(frames, torch.chunk(v, len(frames), dim=0)):
                outputs[(name, f, s)] = p

    def predict_poses(self, inputs, outputs):
        sources = list(self.frame_ids[1:])
        if not sources:
            return
        target = inputs[("color_aug", 0, 0)]
        B = target.shape[0]
        pairs = torch.cat([torch.cat([inputs[("color_aug", f, 0)], target], dim=1) for f in sources], dim=0)
        axisangle, translation = self.pose_dec(self.pose_enc(pairs)[-1])
        axisangle, translation = axisangle[:, 0], translation[:, 0]
        for i, f in enumerate(sources):
            aa = axisangle[i * B:(i + 1) * B]
            tr = translation[i * B:(i + 1) * B]
            outputs[("axisangle", 0, f)] = aa
            outputs[("translation", 0, f)] = tr
            outputs[("cam_T_cam", 0, f)] = transformation_from_parameters(aa.float(), tr.float(), invert=True)

    def predict_motions(self, inputs, outputs, bool_CmpFlow, bool_MotMask):
        if not bool_CmpFlow and not bool_MotMask:
            return
        for g in sorted({abs(f) for f in self.frame_ids[1:]}):
            motion_input = torch.cat(
                [inputs[("color_aug", -g, 0)], inputs[("color_aug", 0, 0)], inputs[("color_aug", g, 0)]], dim=1
            )
            pyramid = [motion_input] + list(self.motion_enc(motion_input))
            # Detached antisymmetric mean, translation first (model.py:131-133).
            ego_t = (outputs[("translation", 0, -g)] - outputs[("translation", 0, g)]) / 2
            ego_aa = (outputs[("axisangle", 0, -g)] - outputs[("axisangle", 0, g)]) / 2
            ego = torch.cat([ego_t, ego_aa], dim=-1).detach()
            if bool_CmpFlow:
                for (name, s), v in self.motion_dec(pyramid, ego).items():
                    outputs[(name, -g, s)] = -v
                    outputs[(name, g, s)] = v
            if bool_MotMask:
                for (name, s), v in self.motion_mask(pyramid, ego).items():
                    outputs[(name, -g, s)] = v
                    outputs[(name, g, s)] = v

    def forward(self, inputs: Dict, bool_CmpFlow=True, bool_MotMask=True, generator=None) -> Dict:
        """Train or eval mode follows ``self.training``; ``generator`` feeds
        LiteMono's drop-path draws."""
        outputs: Dict = {}
        self.predict_depths(inputs, outputs, generator)
        self.predict_poses(inputs, outputs)
        self.predict_motions(inputs, outputs, bool_CmpFlow, bool_MotMask)
        return outputs
