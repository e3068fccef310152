"""Pose decoder (reference ``networks/pose_decoder.py``).

1x1 squeeze to 256ch + ReLU, two 3x3 convs + ReLU, a 1x1 head to
6*num_frames, global spatial mean, and the 0.01 output scaling
(pose_decoder.py:16-44). Consumes the last feature of the pose encoder; on a
CUDA card both are channels-last (``models/model.py::lay_out``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class PoseDecoder(nn.Module):
    def __init__(self, in_channels=512, num_frames_to_predict_for=2):
        super().__init__()
        self.num_frames = num_frames_to_predict_for
        self.squeeze = nn.Conv2d(in_channels, 256, 1)
        self.pose0 = nn.Conv2d(256, 256, 3, padding=1)
        self.pose1 = nn.Conv2d(256, 256, 3, padding=1)
        self.pose2 = nn.Conv2d(256, 6 * num_frames_to_predict_for, 1)

    def forward(self, last_feature):
        """(B, C, h, w) -> (axisangle, translation), each (B, num_frames, 3)."""
        x = F.relu(self.squeeze(last_feature))
        x = F.relu(self.pose0(x))
        x = F.relu(self.pose1(x))
        x = 0.01 * torch.mean(self.pose2(x), dim=(2, 3))
        x = x.reshape(x.shape[0], self.num_frames, 6)
        return x[..., :3], x[..., 3:]
