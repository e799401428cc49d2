"""Coding-prior (partition-map) feature extraction, the "GCPI" stage
(counterparts of ``cdfo_tpu/models/prior_encoder.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .attention import MDTA
from .layers import Conv2d, ConvTranspose2d, SpatialAttention
from .norms import ChannelLayerNorm


class SideToFeaUDSA2(nn.Module):
    """conv s1 -> conv s2p2 -> conv s2p2 -> SpatialAttention ->
    convT s2p2 -> convT s2p2 (output_padding 1) -> conv -> in_f channels,
    each followed by lrelu(0.1). The Sequential indices are the reference
    ``state_dict``'s (``body.0`` ... ``body.11``)."""

    def __init__(self, in_f: int, nf: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()

        def act():
            return nn.LeakyReLU(0.1)

        self.body = nn.Sequential(
            Conv2d(in_f, nf, 3, 1, 1, dtype=dtype), act(),
            Conv2d(nf, nf, 3, 2, 2, dtype=dtype), act(),
            Conv2d(nf, nf, 3, 2, 2, dtype=dtype), act(),
            SpatialAttention(dtype=dtype),
            ConvTranspose2d(nf, nf, 3, 2, 2, 0, dtype=dtype), act(),
            ConvTranspose2d(nf, nf, 3, 2, 2, 1, dtype=dtype), act(),
            Conv2d(nf, in_f, 3, 1, 1, dtype=dtype), act())

    def forward(self, side):
        return self.body(side)


class PartitionTransformerSA2(nn.Module):
    """Partition-prior-injected MDTA feature extractor. forward(x1=image
    features, x2=partition features): three rounds, sharing one set of
    weights, of

        x2 = side(x2) + (x1 if round 0 else x2)
        x1 = x1 + attn(norm1(x1))
        x1 = x1 + conv(norm2(x1)) + x2
    """

    def __init__(self, dim: int = 64, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim)
        self.norm2 = ChannelLayerNorm(dim)
        self.attn = MDTA(dim, num_heads, dtype=dtype)
        self.conv = Conv2d(dim, dim, 3, 1, 1, dtype=dtype)
        self.side_to_feaoneUDSA = SideToFeaUDSA2(dim, nf=16, dtype=dtype)

    def forward(self, x1, x2):
        for r in range(3):
            x2 = self.side_to_feaoneUDSA(x2) + (x1 if r == 0 else x2)
            x1 = x1 + self.attn(self.norm1(x1))
            x1 = x1 + self.conv(self.norm2(x1)) + x2
        return x1
