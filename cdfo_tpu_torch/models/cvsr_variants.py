"""The non-flagship models (counterparts of
``cdfo_tpu/models/cvsr_variants.py``), NHWC, on the card unless the caller
asks for another device:

* ``CVSRV7``: a 3-level feature pyramid, coarse-to-fine bidirectional
  deformable alignment (the backward pass over ``mvs0`` and the forward
  pass over ``mvs1`` in one batched call, fused by ``fb_fusion``), the
  pyramid trunk and the pyramid-fuse upsampling head;
* ``SIDECVSRModel``: SFT side-embedded feature extraction, the pyramid, the
  MV patch attention ``MVLocalAttn`` (constructed: the reference's
  ``mv_patch_attn`` is commented out of its ctor, `:4115`, which leaves its
  forward dead; ``cdfo_tpu`` constructs it, the obvious repair), the
  temporal attention ``FeaFusion`` and the pyramid trunk;
* ``CVSRV9``: CVSR_V8 with ``EGLA1`` in the RDAB slot. Its parameters carry
  the reference's names, without the ``body`` scope of ``cdfo_tpu``'s
  wrapper (``compat.from_flax`` drops it).

CVSR_V7's RDAB draws its channel mask's gumbel noise under
``mask_mode="sample"`` from ``generator``, or takes the three uniform draws
``gumbel_u`` of its pyramid levels, coarse to fine.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.resize import interpolate_bilinear, pixel_shuffle
from .alignment_dcn import FeaFusion, MVDualAttAlignment, MVLocalAttn
from .attention import MDTA
from .attention_variants import EGLA1, RDAB
from .cvsr import CVSRV8
from .layers import (Conv2d, SpatialAttention, check_device, init_weights,
                     lrelu)
from .norms import ChannelLayerNorm
from .prior_encoder import SideToFea
from .sft import SideEmbeddedFeatureExtractBlock
from .trunk import SCNetPyr, SCNetPyrScan


class PartitionTransformerBlockPTB(nn.Module):
    """PartitionTransformerBlock (`:1340-1367`), CVSR_V7's feature
    extraction: four shared-weight rounds of x2 = SA(x2), x1 = x1 +
    attn(norm1(x1)) + x2, x1 = x1 + conv(norm2(x1))."""

    def __init__(self, dim: int = 64, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim)
        self.norm2 = ChannelLayerNorm(dim)
        self.attn = MDTA(dim, num_heads, dtype=dtype)
        self.conv = Conv2d(dim, dim, 3, 1, 1, dtype=dtype)
        self.SA = SpatialAttention(dtype=dtype)

    def forward(self, x1, x2):
        for _ in range(4):
            x2 = self.SA(x2)
            x1 = x1 + self.attn(self.norm1(x1)) + x2
            x1 = x1 + self.conv(self.norm2(x1))
        return x1


def _pyramid(l1):
    """[l1, l1 at 1/2, l1 at 1/4] (bilinear)."""
    l2 = interpolate_bilinear(l1, scale_factor=0.5)
    return [l1, l2, interpolate_bilinear(l2, scale_factor=0.5)]


def _at_level(t, pyr_i):
    """A prior or a flow at pyramid level ``pyr_i``: resized by 1/2^i and,
    being in pixel units, divided by 2^i."""
    if pyr_i == 0:
        return t
    return interpolate_bilinear(t, scale_factor=0.5 ** pyr_i) / 2.0 ** pyr_i


class _PyramidHead(nn.Module):
    """The pyramid-fuse upsampling head of CVSR_V7 and SIDECVSR: levels 3
    and 2 projected (1x1) and pixel-shuffled to full size, concatenated
    with level 1, then two (conv + PixelShuffle(2)) stages, conv_last, plus
    the bilinear x4 base."""

    def __init__(self, nf: int, k_up1: int, k_last: int, dtype):
        super().__init__()
        fused = nf + nf // 4 + nf // 16
        self.upconv1_L3 = Conv2d(nf, nf, 1, dtype=dtype)
        self.upconv1_L2 = Conv2d(nf, nf, 1, dtype=dtype)
        self.upconv1 = Conv2d(fused, nf * 4, k_up1, 1, k_up1 // 2,
                              dtype=dtype)
        self.upconv2 = Conv2d(nf, nf * 4, 1, dtype=dtype)
        self.conv_last = Conv2d(nf, 1, k_last, 1, k_last // 2, dtype=dtype)

    def head(self, out, x_center):
        l3 = pixel_shuffle(pixel_shuffle(lrelu(self.upconv1_L3(out[2])), 2), 2)
        l2 = pixel_shuffle(lrelu(self.upconv1_L2(out[1])), 2)
        o = torch.cat([out[0], l2, l3], dim=-1)
        o = lrelu(pixel_shuffle(self.upconv1(o), 2))
        o = lrelu(pixel_shuffle(self.upconv2(o), 2))
        o = self.conv_last(o)
        return (o + interpolate_bilinear(x_center, scale_factor=4.0)).float()


def _embed_window(pre_l1, new, b, n, h, w, nf):
    """The window's L1 features (b*n, h, w, nf): ``pre_l1`` shifted by one
    frame and the newest frame's features appended."""
    l1 = torch.cat([pre_l1.to(new.dtype)[:, 1:], new[:, None]], dim=1)
    return l1.reshape(b * n, h, w, nf)


class CVSRV7(_PyramidHead):
    """CVSR_V7 (`:4215-4367`). forward(x, mvs0, mvs1, pms, rms, ufs,
    pre_l1=None, generator=None, gumbel_u=None) -> (sr (B, 4H, 4W, 1)
    float32, l1 (B, N, H, W, nf))."""

    takes_mv_pair = True   # the signature StreamingInferencer drives

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device | str = "cuda"):
        check_device(device, type(self).__name__)
        nf, dt = cfg.nf, cfg.compute_dtype
        super().__init__(nf, 1, 1, dt)
        self.cfg = cfg
        self.conv_first = Conv2d(1, nf, 3, 1, 1, dtype=dt)
        self.conv_second = Conv2d(1, nf, 3, 1, 1, dtype=dt)
        self.transformer_feature_extraction = nn.ModuleDict({
            "path1": PartitionTransformerBlockPTB(nf, cfg.mdta_heads,
                                                  dtype=dt)})
        self.conv_expand_fea_r = Conv2d(2 * nf, nf, 3, 1, 1, dtype=dt)
        self.conv_expand_ufs = Conv2d(1, nf, 3, 1, 1, dtype=dt)
        self.conv_expand_rms = Conv2d(1, nf, 3, 1, 1, dtype=dt)
        self.fb_fusion = Conv2d(2 * nf, nf, 1, dtype=dt)
        self.tsa_fusion = Conv2d(cfg.nframes * nf, nf, 1, dtype=dt)
        self.RDAB = RDAB(nf, mask_mode=cfg.mask_mode, dtype=dt)
        self.MV_deform_align = MVDualAttAlignment(nf, 3, 1, 16, 10.0,
                                                  dtype=dt)
        trunk = SCNetPyrScan if cfg.scan_trunk else SCNetPyr
        self.recon_trunk = trunk(nf, cfg.scn_groups, dtype=dt)
        init_weights(self, generator)
        self.to(device)

    def _embed(self, frames, pms):
        l1 = lrelu(self.conv_first(frames))
        return self.transformer_feature_extraction["path1"](
            l1, self.conv_second(pms))

    def forward(self, x, mvs0, mvs1, pms, rms, ufs,
                pre_l1: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                gumbel_u: Optional[Sequence[torch.Tensor]] = None):
        cfg = self.cfg
        dt, nf, c = cfg.compute_dtype, cfg.nf, cfg.center
        b, n, h, w, _ = x.shape
        x, pms, rms, ufs = (t.to(dt) for t in (x, pms, rms, ufs))
        mvs0, mvs1 = mvs0.to(dt), mvs1.to(dt)
        if pre_l1 is None:
            l1 = self._embed(x.reshape(b * n, h, w, 1),
                             pms.reshape(b * n, h, w, 1))
        else:
            l1 = _embed_window(pre_l1, self._embed(x[:, -1], pms[:, -1]),
                               b, n, h, w, nf)
        feas = _pyramid(l1)
        nbr = [i for i in range(n) if i != c]
        m = len(nbr)

        def nbrs(t):   # (b, n, ...) -> neighbour-major (m*b, ...)
            return t[:, nbr].transpose(0, 1).reshape(m * b, *t.shape[2:])

        fuse_pyr, prev = [], None
        for level, pyr_i in enumerate((2, 1, 0)):      # L3 -> L1
            hh, ww = feas[pyr_i].shape[1:3]
            fea_lv = feas[pyr_i].reshape(b, n, hh, ww, nf)
            ufs_p = self.conv_expand_ufs(_at_level(nbrs(ufs), pyr_i))
            rms_p = self.conv_expand_rms(_at_level(nbrs(rms), pyr_i))
            fea_nb = nbrs(fea_lv)
            fea_com = fea_nb + rms_p
            if prev is not None:
                fea_com = fea_com + interpolate_bilinear(nbrs(prev),
                                                         scale_factor=2.0)
            u = None if gumbel_u is None else gumbel_u[level]
            x_n = self.RDAB(rms_p, fea_com, generator, u)
            fea_i = self.conv_expand_fea_r(torch.cat([fea_nb, x_n], dim=-1))
            # both directions in one call: the weights are shared
            cen = fea_lv[:, c].repeat(m, 1, 1, 1)
            mv = torch.cat([_at_level(nbrs(t), pyr_i) for t in (mvs0, mvs1)])
            both = self.MV_deform_align(cen.repeat(2, 1, 1, 1),
                                        fea_i.repeat(2, 1, 1, 1),
                                        ufs_p.repeat(2, 1, 1, 1), mv)
            fused = self.fb_fusion(torch.cat([both[:m * b], both[m * b:]],
                                             dim=-1))
            fused = fused.reshape(m, b, hh, ww, nf).transpose(0, 1)
            prev = torch.cat([fused[:, :c], fea_lv[:, c:c + 1],
                              fused[:, c:]], dim=1)
            flat = prev.permute(0, 2, 3, 1, 4).reshape(b, hh, ww, n * nf)
            fuse_pyr.append(lrelu(self.tsa_fusion(flat)))
        out = self.recon_trunk(fuse_pyr[::-1])           # [L1, L2, L3]
        return self.head(out, x[:, c]), l1.reshape(b, n, h, w, nf)


class SIDECVSRModel(_PyramidHead):
    """SIDECVSR (`:4089-4211`), repaired. forward(x, mvs, pms, rms, ufs,
    pre_l1=None) -> (sr float32, l1 (B, N, H, W, nf)). Its side features:
    without ``pre_l1`` the partition maps alone, tiled to three channels
    (the reference's active path, `:4143`); with it, the newest frame's
    rms, pms and ufs concatenated (its commented path, `:4134`), as
    ``cdfo_tpu`` does."""

    takes_mv_pair = False   # one MV field: StreamingInferencer refuses it

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device | str = "cuda"):
        check_device(device, type(self).__name__)
        nf, dt = cfg.nf, cfg.compute_dtype
        super().__init__(nf, 3, 3, dt)
        self.cfg = cfg
        self.conv_first = Conv2d(1, nf, 3, 1, 1, dtype=dt)
        self.feature_extraction = SideEmbeddedFeatureExtractBlock(nf,
                                                                  dtype=dt)
        self.side_fea_ext = SideToFea(nf // 2, dtype=dt)
        self.mv_patch_attn = MVLocalAttn(nf, 3, dtype=dt)
        self.tmp_fea_attn = FeaFusion(nf, cfg.nframes, dtype=dt)
        self.tsa_fusion = Conv2d(cfg.nframes * nf, nf, 1, dtype=dt)
        trunk = SCNetPyrScan if cfg.scan_trunk else SCNetPyr
        self.recon_trunk = trunk(nf, cfg.scn_groups, dtype=dt)
        init_weights(self, generator)
        self.to(device)

    def forward(self, x, mvs, pms, rms, ufs,
                pre_l1: Optional[torch.Tensor] = None):
        cfg = self.cfg
        dt, nf, c = cfg.compute_dtype, cfg.nf, cfg.center
        b, n, h, w, _ = x.shape
        x, mvs, pms, rms, ufs = (t.to(dt) for t in (x, mvs, pms, rms, ufs))
        if pre_l1 is None:
            l1 = lrelu(self.conv_first(x.reshape(b * n, h, w, 1)))
            sides = pms.reshape(b * n, h, w, 1).repeat(1, 1, 1, 3)
            l1 = self.feature_extraction(l1, self.side_fea_ext(sides))
        else:
            new = lrelu(self.conv_first(x[:, -1]))
            sides = torch.cat([rms[:, -1], pms[:, -1], ufs[:, -1]], dim=-1)
            new = self.feature_extraction(new, self.side_fea_ext(sides))
            l1 = _embed_window(pre_l1, new, b, n, h, w, nf)
        feas = _pyramid(l1)
        nbr = [i for i in range(n) if i != c]
        m = len(nbr)
        fuse_pyr = []
        for pyr_i in range(3):
            hh, ww = feas[pyr_i].shape[1:3]
            fea_lv = feas[pyr_i].reshape(b, n, hh, ww, nf)
            # the neighbours folded into the batch (shared weights)
            nb = fea_lv[:, nbr].reshape(b * m, hh, ww, nf)
            cen = fea_lv[:, c:c + 1].expand(b, m, hh, ww, nf) \
                .reshape(b * m, hh, ww, nf)
            mv = _at_level(mvs[:, nbr].reshape(b * m, h, w, 2), pyr_i)
            aligned = self.mv_patch_attn(nb, cen, mv).reshape(b, m, hh, ww,
                                                              nf)
            frames = torch.cat([aligned[:, :c], fea_lv[:, c:c + 1],
                                aligned[:, c:]], dim=1)
            flat = frames.permute(0, 2, 3, 1, 4).reshape(b, hh, ww, n * nf)
            fuse_pyr.append(lrelu(self.tsa_fusion(self.tmp_fea_attn(flat))))
        out = self.recon_trunk(fuse_pyr)
        return self.head(out, x[:, c]), l1.reshape(b, n, h, w, nf)


class CVSRV9(CVSRV8):
    """CVSR_V9 (`:5019-5126`): CVSR_V8 with ``EGLA1`` (LLongRangAttention_1)
    in the RDAB slot. Runs per window (``StreamingInferencer``)."""

    def _make_rdab(self) -> nn.Module:
        return EGLA1(self.cfg.nf, dtype=self.cfg.compute_dtype)
