"""The SFT (spatial feature transform) conditioning stack of SIDECVSR
(counterpart of ``cdfo_tpu/models/sft.py``; `arch/SIDECVSR_our.py:608-637,
1117-1140`), NHWC."""
from __future__ import annotations

import torch
from torch import nn

from .layers import Conv2d, lrelu


class SFTLayer(nn.Module):
    """Scale and shift predicted from concat(features, side features); the
    side features carry nf // 2 channels. feas * (scale + 1) + shift."""

    def __init__(self, nf: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = nf + nf // 2
        self.SFT_scale_conv0 = Conv2d(cin, nf, 1, dtype=dtype)
        self.SFT_scale_conv1 = Conv2d(nf, nf, 1, dtype=dtype)
        self.SFT_shift_conv0 = Conv2d(cin, nf, 1, dtype=dtype)
        self.SFT_shift_conv1 = Conv2d(nf, nf, 1, dtype=dtype)

    def forward(self, feas, side_feas):
        x_in = torch.cat([feas, side_feas], dim=-1)
        scale = self.SFT_scale_conv1(lrelu(self.SFT_scale_conv0(x_in)))
        shift = self.SFT_shift_conv1(lrelu(self.SFT_shift_conv0(x_in)))
        return feas * (scale + 1.0) + shift


class ResBlockSFT(nn.Module):
    """SFT -> conv -> ReLU -> SFT -> conv, plus the skip (`:624-637`)."""

    def __init__(self, nf: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sft0 = SFTLayer(nf, dtype=dtype)
        self.conv0 = Conv2d(nf, nf, 3, 1, 1, dtype=dtype)
        self.sft1 = SFTLayer(nf, dtype=dtype)
        self.conv1 = Conv2d(nf, nf, 3, 1, 1, dtype=dtype)

    def forward(self, feas, side_feas):
        fea = torch.relu(self.conv0(self.sft0(feas, side_feas)))
        return feas + self.conv1(self.sft1(fea, side_feas))


class SideEmbeddedFeatureExtractBlock(nn.Module):
    """Seven stacked SFT residual blocks, ``RB_wSide_1`` ... ``RB_wSide_7``
    (`:1117-1139`)."""

    def __init__(self, nf: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(1, 8):
            self.add_module(f"RB_wSide_{i}", ResBlockSFT(nf, dtype=dtype))

    def forward(self, img_feas, side_feas):
        fea = img_feas
        for i in range(1, 8):
            fea = getattr(self, f"RB_wSide_{i}")(fea, side_feas)
        return fea
