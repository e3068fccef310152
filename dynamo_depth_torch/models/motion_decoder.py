"""Motion decoder (reference ``networks/motion_decoder.py``).

Coarse-to-fine refinement of a motion field seeded from the (detached)
ego-motion vector: a 1x1 conv maps ``100 * ego_motion`` (6-vector) to the
output dim, then per pyramid level (coarsest -> finest, ending at the raw
input image) the field is bilinearly upsampled, concatenated with the
encoder feature, passed through two 3x3 convs, reduced by a 1x1 conv over
the concat of both conv outputs, and added residually
(motion_decoder.py:36-62). Heads emit ``0.01 * field`` as either a 3-channel
complete flow or a 1-channel motion logit + sigmoid mask per scale.

Layout: on a CUDA card every weight is channels-last, as the ResNet
encoder's features are (``models/model.py::lay_out``); the level fed by the
raw stacked frames too, where cuDNN runs the 3x3 convolutions over 9-12
channels at full resolution 3x faster in NHWC. The upsampled field takes the
layout of the map it is concatenated with, and the outputs leave in NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dynamo_depth_torch.models.layers import memory_format
from dynamo_depth_torch.ops.warp import resize_bilinear


class MotionDecoder(nn.Module):
    def __init__(self, num_ch_enc, scales=(0, 1, 2), num_input_images=3, out_dim=3):
        super().__init__()
        if out_dim not in (1, 3):
            raise ValueError(f"out_dim={out_dim} not supported")
        self.scales = tuple(scales)
        self.out_dim = out_dim
        # Pyramid channels, coarsest first: encoder levels then the raw input.
        level_ch = [int(c) for c in num_ch_enc][::-1] + [3 * num_input_images]
        self.num_levels = len(level_ch)
        self._residual_translation = nn.Conv2d(6, out_dim, 1)
        for ii, fc in enumerate(level_ch):
            setattr(self, f"refine_motion_conv{ii}", nn.ModuleList([
                nn.Conv2d(out_dim + fc, fc, 3, padding=1),
                nn.Conv2d(fc, fc, 3, padding=1),
            ]))
            setattr(self, f"refine_motion_redu{ii}", nn.Conv2d(2 * fc, out_dim, 1))

    def forward(self, pyramid, ego_motion):
        """
        :param pyramid: [input_image (B, 3*num_input_images, H, W), feat_1/2,
                         feat_1/4, feat_1/8, feat_1/16, feat_1/32]
        :param ego_motion: (B, 6) detached ego-motion conditioning vector
        :return: {('complete_flow', s): (B, 3, h_s, w_s)} or
                 {('motion_prob'|'motion_mask', s): (B, 1, h_s, w_s)}
        """
        field = self._residual_translation((100.0 * ego_motion)[:, :, None, None])
        per_level = []
        for ii in range(self.num_levels):
            feat = pyramid[-1 - ii]
            up = resize_bilinear(field, feat.shape[2:]).contiguous(memory_format=memory_format(feat))
            conv0, conv1 = getattr(self, f"refine_motion_conv{ii}")
            c1 = conv0(torch.cat([up, feat], dim=1))
            c2 = conv1(c1)
            field = getattr(self, f"refine_motion_redu{ii}")(torch.cat([c1, c2], dim=1)) + up
            per_level.append(field)

        outputs = {}
        for scale in self.scales:
            m_raw = (0.01 * per_level[self.num_levels - 1 - scale]).contiguous()
            if self.out_dim == 1:
                outputs[("motion_prob", scale)] = m_raw
                outputs[("motion_mask", scale)] = torch.sigmoid(m_raw)
            else:
                outputs[("complete_flow", scale)] = m_raw
        return outputs
