"""Coding-prior (partition-map) feature extraction, the "GCPI" stage
(counterparts of ``cdfo_tpu/models/prior_encoder.py``): the partition
branch's U-shaped side encoder, the three shared-weight rounds of
CVSR_V8 (``PartitionTransformerSA2``, eager or fused), their woPAB ablation
without the partition branch, and SIDECVSR's four-conv side encoder
``SideToFea``; and the family's members that no registry model builds: the
side encoders ``SideToFeaOne``, ``SideToFeaUD`` and ``SideToFeaUDK``,
``TransformerBlockSimple``, and the four- and three-round
``PartitionTransformerSA`` / ``PartitionTransformerSA1``, which run the
plain ``MDTA`` as ``cdfo_tpu`` does."""
from __future__ import annotations

import torch
from torch import nn

from ..ops.cuda_build import cached_pack
from ..ops.fused_mdta import (attention_matrix, mdta_stage1, mdta_stage2,
                              pack_stage1_weights, pack_stage2_weights)
from ..parallel import spatial
from .attention import MDTA
from .layers import Conv2d, ConvTranspose2d, SpatialAttention
from .norms import ChannelLayerNorm


class SideToFeaUDSA2(nn.Module):
    """conv s1 -> conv s2p2 -> conv s2p2 -> SpatialAttention ->
    convT s2p2 -> convT s2p2 (output_padding 1) -> conv -> in_f channels,
    each followed by lrelu(0.1). The Sequential indices are the reference
    ``state_dict``'s (``body.0`` ... ``body.11``).

    The stride-2 convs map 16 rows to 9 and 6, and the transposed ones back
    to 9 and 16: no shard's rows map onto a shard's. So under a row split
    ``body.0`` runs on this rank's rows (with its halo), its ``nf``-channel
    output is gathered whole, every rank runs the rest on all of it and
    keeps its own rows."""

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
        shard = spatial.split()
        if shard is None:
            return self.body(side)
        head = self.body[1](self.body[0](side))
        whole = spatial.gather_rows(head, shard, "side_gather")
        with spatial.sharded(None):
            out = self.body[2:](whole)
        start, stop = shard.bounds_at(side.shape[1])
        return out[:, start:stop]


class SideToFea(nn.Module):
    """Four 3x3 convs, each followed by lrelu(0.1), from 3 side channels to
    ``nf`` (`arch/SIDECVSR_our.py:1696-1712`; ``body.0`` ... ``body.6``)."""

    def __init__(self, nf: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        layers = []
        for i in range(4):
            layers += [Conv2d(3 if i == 0 else nf, nf, 3, 1, 1, dtype=dtype),
                       nn.LeakyReLU(0.1)]
        self.body = nn.Sequential(*layers)

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


class PartitionTransformerSA2Fast(PartitionTransformerSA2):
    """``PartitionTransformerSA2`` with each round's MDTA and conv as the
    two passes of ``ops/fused_mdta`` (``mdta_stage1``, the per-head
    ``attention_matrix``, ``mdta_stage2``), as JAX's
    ``PartitionTransformerSA2Fast``. Same parameters and ``state_dict``
    keys; the 16-channel side U-Net stays eager. The packed weights of
    both passes are kept until a parameter changes
    (``cuda_build.cached_pack``)."""

    def forward(self, x1, x2):
        attn = self.attn
        n1, n2 = self.norm1.body, self.norm2.body
        x1, x2n = x1.contiguous(), x2
        wq, wdw = attn.qkv.weight, attn.qkv_dwconv.weight
        wp, wc = attn.project_out.weight, self.conv.weight
        packed = cached_pack(self, "_stage1_pack", x1, (wq, wdw),
                             lambda dt: pack_stage1_weights(wq, wdw, dt))
        packed2 = cached_pack(self, "_stage2_pack", x1, (wp, wc),
                              lambda dt: pack_stage2_weights(wp, wc, dt))
        for r in range(3):
            x2n = self.side_to_feaoneUDSA(x2n) + (x1 if r == 0 else x2n)
            v, stats = mdta_stage1(x1, n1["weight"], n1["bias"], wq, wdw,
                                   packed=packed)
            amat = attention_matrix(stats, attn.temperature, attn.num_heads)
            x1 = mdta_stage2(x1, v, x2n.contiguous(), amat.to(x1.dtype), wp,
                             n2["weight"], n2["bias"], wc, self.conv.bias,
                             packed=packed2)
        return x1


class PartitionTransformerSAWoPAB(nn.Module):
    """The woPAB ablation's feature extractor (`arch/SIDECVSR_our.py:
    1480-1514`): three shared-weight rounds of x1 + attn(norm1(x1)), then
    x1 + conv(norm2(x1)), with no partition branch. forward(x1)."""

    def __init__(self, dim: int = 64, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim)
        self.norm2 = ChannelLayerNorm(dim)
        self.attn = MDTA(dim, num_heads, dtype=dtype)
        self.conv = Conv2d(dim, dim, 3, 1, 1, dtype=dtype)

    def forward(self, x1):
        for _ in range(3):
            x1 = x1 + self.attn(self.norm1(x1))
            x1 = x1 + self.conv(self.norm2(x1))
        return x1


class SideToFeaOne(nn.Module):
    """Two 3x3 convs, each followed by lrelu(0.1)
    (`arch/SIDECVSR_our.py:1716-1732`; ``body.0``, ``body.2``)."""

    def __init__(self, in_ch: int = 1, nf: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(in_ch, nf, 3, 1, 1, dtype=dtype), nn.LeakyReLU(0.1),
            Conv2d(nf, nf, 3, 1, 1, dtype=dtype), nn.LeakyReLU(0.1))

    def forward(self, side):
        return self.body(side)


class SideToFeaUDK(nn.Module):
    """The stride-2 U encoder without spatial attention, ``in_f`` channels
    in and out (`:1760-1780`): conv s2p2, conv s2p2, conv, convT s2p2,
    convT s2p2 (output_padding 1), conv, each followed by lrelu(0.1)
    (``body.0`` ... ``body.10``)."""

    def __init__(self, in_f: int, nf: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()

        def act():
            return nn.LeakyReLU(0.1)

        self.body = nn.Sequential(
            Conv2d(in_f, nf, 3, 2, 2, dtype=dtype), act(),
            Conv2d(nf, nf, 3, 2, 2, dtype=dtype), act(),
            Conv2d(nf, nf, 3, 1, 1, dtype=dtype), act(),
            ConvTranspose2d(nf, nf, 3, 2, 2, 0, dtype=dtype), act(),
            ConvTranspose2d(nf, nf, 3, 2, 2, 1, dtype=dtype), act(),
            Conv2d(nf, in_f, 3, 1, 1, dtype=dtype), act())

    def forward(self, side):
        return self.body(side)


class SideToFeaUD(SideToFeaUDK):
    """``SideToFeaUDK`` with one channel in and out
    (`arch/SIDECVSR_our.py:1736-1756`)."""

    def __init__(self, nf: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__(1, nf, dtype)


class TransformerBlockSimple(nn.Module):
    """TransformerBlock (`:1317-1336`): one ``x + attn(norm1(x))``; the
    reference's ffn and conv branches are commented out."""

    def __init__(self, dim: int = 64, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim)
        self.attn = MDTA(dim, num_heads, dtype=dtype)

    def forward(self, x):
        return x + self.attn(self.norm1(x))


class PartitionTransformerSA(nn.Module):
    """`:1371-1398`: four rounds, sharing one set of weights, of

        x2 = side(x2)                      (a fresh encode, not accumulated)
        x1 = x1 + attn(norm1(x1)) + x2
        x1 = x1 + conv(norm2(x1))

    forward(x1=image features, x2=partition features)."""

    rounds = 4

    def __init__(self, dim: int = 64, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim)
        self.norm2 = ChannelLayerNorm(dim)
        self.attn = MDTA(dim, num_heads, dtype=dtype)
        self.conv = Conv2d(dim, dim, 3, 1, 1, dtype=dtype)
        self.side_to_feaoneUDSA = SideToFeaUDSA2(dim, nf=16, dtype=dtype)

    def forward(self, x1, x2):
        for _ in range(self.rounds):
            x2 = self.side_to_feaoneUDSA(x2)
            x1 = x1 + self.attn(self.norm1(x1)) + x2
            x1 = x1 + self.conv(self.norm2(x1))
        return x1


class PartitionTransformerSA1(PartitionTransformerSA):
    """`:1403-1436`: ``PartitionTransformerSA`` in three rounds."""

    rounds = 3
