"""CVSR_V8, the coding-prior-guided video-SR model (counterpart of
``cdfo_tpu/models/cvsr.py`` on its non-fused NHWC branch).

Inputs (channels-last):
  lrs  (B, N, H, W, 1)  decoded LR Y frames, [0,1]
  mvs0 (B, N, H, W, 2)  expanded L0 flows (kept for API parity; V8 uses L1)
  mvs1 (B, N, H, W, 2)  expanded L1 flows, pixel units (dx, dy)
  pms  (B, N, H, W, 1)  partition maps, [0,1]
  rms  (B, N, H, W, 1)  residual maps, [0,1]
  ufs  (B, N, H, W, 1)  unfiltered prediction frames, [0,1]
  pre_l1 (B, N, H, W, nf) optional recurrent feature cache

``forward`` returns (sr (B, 4H, 4W, 1) float32, l1_fea (B, N, H, W, nf)).
The streaming engine calls ``compensate_frames`` once per new frame and
``align_reconstruct`` for k centre frames at a time.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.resize import interpolate_bilinear, pixel_shuffle
from ..ops.warp import flow_warp_ring
from .alignment import DualAttAlignment
from .attention import EGLA
from .layers import Conv2d, init_weights, lrelu
from .prior_encoder import PartitionTransformerSA2
from .trunk import SCNetS


class CVSRV8(nn.Module):
    """CVSR_V8 built on ``device`` with weights drawn from ``generator``
    (a CPU ``torch.Generator``; load trained or converted weights with
    ``load_state_dict``)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        nf, dt = cfg.nf, cfg.compute_dtype
        self.conv_first = Conv2d(1, nf, 3, 1, 1, dtype=dt)
        self.conv_second = Conv2d(1, nf, 3, 1, 1, dtype=dt)
        self.transformer_feature_extraction = nn.ModuleDict({
            "path1": PartitionTransformerSA2(nf, cfg.mdta_heads, dtype=dt)})
        self.conv_expand_fea_r = Conv2d(2 * nf, nf, 3, 1, 1, dtype=dt)
        self.conv_expand_ufs = Conv2d(1, nf, 3, 1, 1, dtype=dt)
        self.conv_expand_rms = Conv2d(1, nf, 3, 1, 1, dtype=dt)
        # tsa_fusion is a 1x1 conv over the frame-major (N*nf) channel
        # concat; it is applied as a frame contraction (see _tsa)
        self.tsa_fusion = Conv2d(cfg.nframes * nf, nf, 1, dtype=dt)
        self.recon_trunk = SCNetS(nf, cfg.scn_groups, dtype=dt)
        self.upconv1 = Conv2d(nf, nf * 4, 1, dtype=dt)
        self.upconv2 = Conv2d(nf, nf * 4, 1, dtype=dt)
        self.conv_last = Conv2d(nf, 1, 3, 1, 1, dtype=dt)
        self.MV_deform_align = DualAttAlignment(nf, cfg.align_heads, dtype=dt)
        self.RDAB = EGLA(nf, dtype=dt)
        init_weights(self, generator)
        self.to(device)

    def embed(self, frames, pms):
        """Shared-weight feature extraction: (M, H, W, 1) x2 -> (M, H, W, nf)."""
        l1 = lrelu(self.conv_first(frames))
        return self.transformer_feature_extraction["path1"](
            l1, self.conv_second(pms))

    def _compensate(self, fea, rms):
        """Spatial-compensate block -> aligner input ``fea_i``; depends on
        the neighbour frame only. fea (M, H, W, nf), rms (M, H, W, 1)."""
        rms_prior = self.conv_expand_rms(rms)
        x_n = self.RDAB(rms_prior, fea + rms_prior)
        return self.conv_expand_fea_r(torch.cat([fea, x_n], dim=-1))

    def _tsa(self, nbr, center=None):
        """tsa_fusion as a frame contraction, without materialising the
        channel concat. ``center`` None: ``nbr`` is all N frames
        (B, N, H, W, nf); else ``nbr`` holds the N-1 neighbours in temporal
        order and ``center`` (B, H, W, nf) the centre frame."""
        n, nf, dt = self.cfg.nframes, self.cfg.nf, self.cfg.compute_dtype
        # (out, n*nf, 1, 1) -> (n, nf_in, nf_out): torch channel order is
        # frame-major
        w = self.tsa_fusion.weight[:, :, 0, 0].t().reshape(n, nf, nf)
        if center is None:
            out = torch.einsum("bnhwc,nco->bhwo", nbr.to(dt), w)
        else:
            c = n // 2
            wn = torch.cat([w[:c], w[c + 1:]], dim=0)
            out = (torch.einsum("bnhwc,nco->bhwo", nbr.to(dt), wn)
                   + torch.einsum("bhwc,co->bhwo", center.to(dt), w[c]))
        return out + self.tsa_fusion.bias

    def _reconstruct(self, nbr, center, center_lr):
        """tsa fusion + trunk + head + bilinear base -> SR float32."""
        return self.head_from_trunk(
            self.recon_trunk(lrelu(self._tsa(nbr, center))), center_lr)

    def head_from_trunk(self, out, center_lr):
        """Two (1x1 conv + PixelShuffle(2)) stages, conv_last, plus the
        bilinear x``scale`` upsample of the centre LR frame."""
        dt = self.cfg.compute_dtype
        out = lrelu(pixel_shuffle(self.upconv1(out), 2))
        out = lrelu(pixel_shuffle(self.upconv2(out), 2))
        out = self.conv_last(out)
        base = interpolate_bilinear(center_lr.to(dt),
                                    scale_factor=float(self.cfg.scale))
        return (out + base).float()

    def compensate_frames(self, lrs, pms, rms, ufs):
        """Per-frame, centre-independent stage.

        lrs/pms/rms/ufs (M, H, W, 1), priors already max(1, i)-indexed by
        the caller. Returns (l1 (M, H, W, nf), fea_i (M, H, W, nf), the
        compensated feature the neighbour warp samples, and ufs_prior
        (M, H, W, nf)).
        """
        dt = self.cfg.compute_dtype
        l1 = self.embed(lrs.to(dt), pms.to(dt))
        fea_i = self._compensate(l1, rms.to(dt))
        return l1, fea_i, self.conv_expand_ufs(ufs.to(dt))

    def align_reconstruct(self, center_l1, center_lr, ring_fi, nbr_ufs_p,
                          nbr_mv, nbr_idx):
        """Per-centre stage, batched over k output frames.

        center_l1 (k, H, W, nf); center_lr (k, H, W, 1); ring_fi
        (L, H, W, nf) compensated features of every ring slot; nbr_ufs_p
        (k, N-1, H, W, nf); nbr_mv (k, N-1, H, W, 2) expanded L1 flows;
        nbr_idx (k, N-1) ring slots of the neighbours in temporal order,
        centre excluded. Returns SR (k, sH, sW, 1) float32. The neighbour
        warp gathers straight from the ring.
        """
        cfg = self.cfg
        dt = cfg.compute_dtype
        k, nm1 = nbr_idx.shape
        _, h, w, _ = center_l1.shape
        center_l1 = center_l1.to(dt)
        ufs_p = nbr_ufs_p.to(dt).reshape(k * nm1, h, w, cfg.nf)
        mv = nbr_mv.to(dt).reshape(k * nm1, h, w, 2)
        warped = flow_warp_ring(ring_fi.to(dt), nbr_idx.reshape(k * nm1), mv)
        center_rep = center_l1[:, None].expand(k, nm1, h, w, cfg.nf) \
            .reshape(k * nm1, h, w, cfg.nf)
        aligned = self.MV_deform_align(center_rep, None, ufs_p, mv,
                                       warped_feat=warped)
        aligned = aligned.reshape(k, nm1, h, w, cfg.nf)
        return self._reconstruct(aligned, center_l1, center_lr)

    def forward(self, lrs, mvs0, mvs1, pms, rms, ufs,
                pre_l1: Optional[torch.Tensor] = None):
        cfg = self.cfg
        b, n, h, w, _ = lrs.shape
        center = cfg.center
        dt = cfg.compute_dtype
        lrs, pms, rms, ufs = (t.to(dt) for t in (lrs, pms, rms, ufs))

        # 1. GCPI feature extraction (with the recurrent cache)
        if pre_l1 is None:
            l1_fea = self.embed(lrs.reshape(b * n, h, w, 1),
                                pms.reshape(b * n, h, w, 1))
            l1_fea = l1_fea.reshape(b, n, h, w, cfg.nf)
        else:
            new_fea = self.embed(lrs[:, -1], pms[:, -1])
            l1_fea = torch.cat([pre_l1.to(dt)[:, 1:], new_fea[:, None]],
                               dim=1)
        center_fea = l1_fea[:, center]

        # 2. per-neighbour spatial compensation + alignment, neighbours
        #    folded into batch
        nbr_idx = [i for i in range(n) if i != center]

        def nbrs(t):
            return t[:, nbr_idx].reshape(b * (n - 1), h, w, t.shape[-1])

        ufs_prior = self.conv_expand_ufs(nbrs(ufs))
        fea_i = self._compensate(nbrs(l1_fea), nbrs(rms))
        center_rep = center_fea[:, None].expand(b, n - 1, h, w, cfg.nf) \
            .reshape(b * (n - 1), h, w, cfg.nf)
        aligned = self.MV_deform_align(center_rep, fea_i, ufs_prior,
                                       nbrs(mvs1.to(dt)))
        aligned = aligned.reshape(b, n - 1, h, w, cfg.nf)

        # re-interleave with the center frame in temporal order
        aligned_fea = torch.cat([aligned[:, :center], center_fea[:, None],
                                 aligned[:, center:]], dim=1)

        # 3+4. fusion, trunk, upsample head, bilinear base
        sr = self._reconstruct(aligned_fea, None, lrs[:, center])
        return sr, l1_fea
