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
Under ``cfg.mask_mode="sample"`` it takes the EGLA mask's gumbel noise as a
``generator`` on the model's device, or as the uniform draw ``gumbel_u``
(B*(N-1), H, W, nf) (``EGLA.sampled_mask``). It is the trainer's forward:
with ``fused_trunk`` the trunk's ``Block_`` and group tails and the head
run as ``ops/fused_vjp``'s autograd Functions (kernel forwards, the
recompute backwards of ``cdfo_tpu/ops/fused_vjp.py``), and EGLA's row and
column attention as ``ops/fused_attention``'s.
The streaming engine calls ``compensate_frames`` once per new frame and
``align_reconstruct`` for k centre frames at a time.

``cfg.fused_trunk`` selects the fused path: the trunk is ``SCNetFast``, the
head one ``ops/fused_head`` call, and in ``align_reconstruct`` the
alignment tail one ``ops/fused_tail`` call, as in the JAX package (whose
``__call__`` keeps the plain alignment tail, as ``forward`` does here).
``cfg.fused_embed`` runs the GCPI rounds as ``PartitionTransformerSA2Fast``
(in ``embed``, so in ``forward`` too); ``cfg.fused_align`` runs
``align_reconstruct``'s dual MSA as ``DualAttAlignment.fused_msa``, which
reads the k centre frames without broadcasting them; ``cfg.fused_egla`` runs
EGLA (``RDAB``, in ``compensate_frames`` and ``forward``) as the two
``ops/fused_egla`` kernels around the column attention, whose long-range
attention then runs in the model's dtype (the unfused EGLA's promotes to
float32). ``cfg.trunk_int8`` (under ``fused_trunk``) runs the trunk's
``Block_`` as the int8 kernel of ``ops/fused_block2_q`` (approximate), and
``cfg.block_warp`` the neighbour warp as ``ops/warp_block``;
``cfg.scan_trunk`` recomputes each trunk group in the backward pass.

The paper's ablations drop a branch each, as ``cdfo_tpu``'s CVSRV8 does,
with the modules of the dropped branch left out: ``use_pab=False`` (woPAB)
embeds without the partition branch (``PartitionTransformerSAWoPAB``, no
``conv_second``); ``use_la=False`` (woLA) compensates with ``EGLAwoLA`` on
the bare feature (no ``conv_expand_rms``); ``use_ga=False`` (woGA) with
``EGLAwoGA``; ``use_egla=False`` adds the residual prior with no attention;
``use_mv=False`` (woMV) aligns with no warp; ``use_pd=False`` (woPd) with no
prediction branch (no ``conv_expand_ufs``; ``compensate_frames`` returns
zeros for its prior, as ``cdfo_tpu``'s does).

The model is built on the card unless the caller asks for another device.

Under a row split (``parallel.spatial.sharded``) ``forward`` takes this
rank's rows of every input and returns its rows of the output: the plain
modules exchange halos and sums themselves. The split runs the plain
CVSR_V8 and the ablations whose modules it covers; the kernel flags,
``scan_trunk``, woLA, the other families and the streaming stages raise
``ValueError``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.cuda_build import cached_pack
from ..ops.fused_head import pack_head_weights
from ..ops.fused_vjp import head_fused
from ..ops.resize import interpolate_bilinear, pixel_shuffle
from ..ops.warp import flow_warp_ring
from ..ops.warp_block import flow_warp_ring_block
from ..parallel import spatial
from .alignment import DualAttAlignment
from .attention import EGLA
from .attention_variants import EGLAwoGA, EGLAwoLA
from .layers import Conv2d, check_device, init_weights, lrelu
from .prior_encoder import (PartitionTransformerSA2,
                            PartitionTransformerSA2Fast,
                            PartitionTransformerSAWoPAB)
from .trunk import SCNetS, SCNetSScan
from .trunk_fast import SCNetFast


class CVSRV8(nn.Module):
    """CVSR_V8 (or one of its ablations, by ``cfg``) built on ``device``
    (the card by default; ``"cpu"`` runs every kernel's plain version)
    with weights drawn from ``generator`` (a
    CPU ``torch.Generator``; load trained or converted weights with
    ``load_state_dict``, a released checkpoint with
    ``compat.load_reference_checkpoint``). With ``capture_features`` each
    ``forward`` keeps its aligned features (B, N, H, W, nf) in
    ``intermediates["aligned_fea"]`` (the reference's featuremap_visual)."""

    # forward(lrs, mvs0, mvs1, pms, rms, ufs, pre_l1): the per-window
    # signature that StreamingInferencer drives
    takes_mv_pair = True

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device | str = "cuda",
                 capture_features: bool = False):
        super().__init__()
        check_device(device, type(self).__name__)
        self.cfg = cfg
        self.capture_features = capture_features
        self.intermediates = {}
        if not cfg.v8_family and type(self) is CVSRV8:
            raise ValueError(f"CVSRV8 builds the CVSR_V8 family, not "
                             f"{cfg.name!r} (models.build_model does)")
        nf, dt = cfg.nf, cfg.compute_dtype
        self.conv_first = Conv2d(1, nf, 3, 1, 1, dtype=dt)
        if cfg.use_pab:
            self.conv_second = Conv2d(1, nf, 3, 1, 1, dtype=dt)
            gcpi = (PartitionTransformerSA2Fast if cfg.fused_embed
                    else PartitionTransformerSA2)
        else:
            gcpi = PartitionTransformerSAWoPAB
        self.transformer_feature_extraction = nn.ModuleDict({
            "path1": gcpi(nf, cfg.mdta_heads, dtype=dt)})
        self.conv_expand_fea_r = Conv2d(2 * nf, nf, 3, 1, 1, dtype=dt)
        if cfg.use_pd:
            self.conv_expand_ufs = Conv2d(1, nf, 3, 1, 1, dtype=dt)
        if cfg.use_la or not cfg.use_egla:
            self.conv_expand_rms = Conv2d(1, nf, 3, 1, 1, dtype=dt)
        # tsa_fusion is a 1x1 conv over the frame-major (N*nf) channel
        # concat; it is applied as a frame contraction (see _tsa)
        self.tsa_fusion = Conv2d(cfg.nframes * nf, nf, 1, dtype=dt)
        if cfg.fused_trunk:
            self.recon_trunk = SCNetFast(nf, cfg.scn_groups, dtype=dt,
                                         use_int8=cfg.trunk_int8)
        else:
            trunk = SCNetSScan if cfg.scan_trunk else SCNetS
            self.recon_trunk = trunk(nf, cfg.scn_groups, dtype=dt)
        self.upconv1 = Conv2d(nf, nf * 4, 1, dtype=dt)
        self.upconv2 = Conv2d(nf, nf * 4, 1, dtype=dt)
        self.conv_last = Conv2d(nf, 1, 3, 1, 1, dtype=dt)
        self.MV_deform_align = DualAttAlignment(
            nf, cfg.align_heads, use_mv=cfg.use_mv, use_pd=cfg.use_pd,
            dtype=dt)
        if cfg.use_egla:
            self.RDAB = self._make_rdab()
        init_weights(self, generator)
        self.to(device)

    def _check_split(self) -> None:
        """Raises ``ValueError`` under a row split for what has none: the
        kernel flags, the scan trunk, woLA's long-range attention and the
        models outside the CVSR_V8 family."""
        if spatial.current_shard() is None:
            return
        cfg = self.cfg
        refused = [f for f in ("fused_trunk", "fused_embed", "fused_align",
                               "fused_egla", "block_warp", "trunk_int8",
                               "scan_trunk") if getattr(cfg, f)]
        if not cfg.v8_family or type(self) is not CVSRV8:
            refused.append(f"model {cfg.name!r}")
        elif cfg.use_egla and not cfg.use_la:
            refused.append("woLA's long-range attention")
        if refused:
            spatial.refuse_split(", ".join(refused))

    def _make_rdab(self) -> nn.Module:
        """The module in the RDAB slot (CVSR_V9 overrides it)."""
        cfg = self.cfg
        if not cfg.use_la:
            return EGLAwoLA(cfg.nf, dtype=cfg.compute_dtype)
        if not cfg.use_ga:
            return EGLAwoGA(cfg.nf, dtype=cfg.compute_dtype)
        return EGLA(cfg.nf, fused=cfg.fused_egla, dtype=cfg.compute_dtype,
                    mask_mode=cfg.mask_mode)

    def embed(self, frames, pms):
        """Shared-weight feature extraction: (M, H, W, 1) x2 -> (M, H, W, nf)
        (woPAB reads no partition map)."""
        l1 = lrelu(self.conv_first(frames))
        if not self.cfg.use_pab:
            return self.transformer_feature_extraction["path1"](l1)
        return self.transformer_feature_extraction["path1"](
            l1, self.conv_second(pms))

    def _compensate(self, fea, rms, generator=None, gumbel_u=None):
        """Spatial-compensate block -> aligner input ``fea_i``; depends on
        the neighbour frame only. fea (M, H, W, nf), rms (M, H, W, 1);
        ``generator`` / ``gumbel_u``: the sampled EGLA mask's noise."""
        cfg = self.cfg
        if not cfg.use_egla:
            x_n = fea + self.conv_expand_rms(rms)
        elif not cfg.use_la:      # woLA: no residual branch at all
            x_n = self.RDAB(fea)
        else:
            rms_prior = self.conv_expand_rms(rms)
            x_n = self.RDAB(rms_prior, fea + rms_prior, generator, gumbel_u)
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
        if self.cfg.fused_trunk:
            params = (self.upconv1.weight, self.upconv1.bias,
                      self.upconv2.weight, self.upconv2.bias,
                      self.conv_last.weight)
            return head_fused(out.contiguous(), center_lr.to(dt).contiguous(),
                              *params, self.conv_last.bias,
                              packed=cached_pack(
                                  self, "_head_pack", out, params,
                                  lambda d: pack_head_weights(*params, d)))
        out = lrelu(pixel_shuffle(self.upconv1(out), 2))
        out = lrelu(pixel_shuffle(self.upconv2(out), 2))
        out = self.conv_last(out)
        base = interpolate_bilinear(center_lr.to(dt),
                                    scale_factor=float(self.cfg.scale))
        return (out + base).float()

    def compensate_frames(self, lrs, pms, rms, ufs,
                          generator: Optional[torch.Generator] = None,
                          gumbel_u: Optional[torch.Tensor] = None):
        """Per-frame, centre-independent stage.

        lrs/pms/rms/ufs (M, H, W, 1), priors already max(1, i)-indexed by
        the caller. Returns (l1 (M, H, W, nf), fea_i (M, H, W, nf), the
        compensated feature the neighbour warp samples, and ufs_prior
        (M, H, W, nf), zeros under woPd). Under ``mask_mode="sample"`` the
        EGLA mask's gumbel noise comes from ``generator`` or is the uniform
        draw ``gumbel_u`` (M, H, W, nf), as in ``forward``.
        """
        spatial.refuse_split("the streaming engine's compensate_frames")
        dt = self.cfg.compute_dtype
        l1 = self.embed(lrs.to(dt), pms.to(dt))
        fea_i = self._compensate(l1, rms.to(dt), generator, gumbel_u)
        ufs_p = (self.conv_expand_ufs(ufs.to(dt)) if self.cfg.use_pd
                 else torch.zeros_like(l1))
        return l1, fea_i, ufs_p

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
        spatial.refuse_split("the streaming engine's align_reconstruct")
        center_l1 = center_l1.to(self.cfg.compute_dtype)
        aligned = self.align_neighbours(
            center_l1, *self.warp_neighbours(ring_fi, nbr_ufs_p, nbr_mv,
                                             nbr_idx))
        return self._reconstruct(aligned, center_l1, center_lr)

    def warp_neighbours(self, ring_fi, nbr_ufs_p, nbr_mv, nbr_idx):
        """``align_reconstruct``'s neighbour warp, with the neighbours
        folded into the batch: (warped (k*(N-1), H, W, nf), ufs prior
        (k*(N-1), H, W, nf), flows (k*(N-1), H, W, 2)), in the compute
        dtype; woMV warps nothing (None) and woPd reads no prior (None).
        With ``cfg.block_warp`` the warp is ``ops/warp_block``'s (one
        kernel launch on the card, its path chosen per 4x4 block on the
        device)."""
        dt, nf = self.cfg.compute_dtype, self.cfg.nf
        k, nm1 = nbr_idx.shape
        _, h, w, _ = ring_fi.shape
        ufs_p = (nbr_ufs_p.to(dt).reshape(k * nm1, h, w, nf)
                 if self.cfg.use_pd else None)
        mv = nbr_mv.to(dt).reshape(k * nm1, h, w, 2)
        if not self.cfg.use_mv:
            return None, ufs_p, mv
        warp = flow_warp_ring_block if self.cfg.block_warp else flow_warp_ring
        warped = warp(ring_fi.to(dt).contiguous(), nbr_idx.reshape(k * nm1),
                      mv.contiguous())
        return warped, ufs_p, mv

    def align_neighbours(self, center_l1, warped, ufs_p, mv):
        """``align_reconstruct``'s dual attention of the k centres
        (k, H, W, nf) in the compute dtype against their warped
        neighbours (``warp_neighbours``): (k, N-1, H, W, nf). With
        ``fused_align`` the centres are read without broadcasting them."""
        cfg = self.cfg
        k, h, w, nf = center_l1.shape
        nm1 = mv.shape[0] // k
        if cfg.fused_align:
            aligned = self.MV_deform_align.fused_msa(warped, ufs_p, center_l1)
        else:
            center_rep = center_l1[:, None].expand(k, nm1, h, w, nf) \
                .reshape(k * nm1, h, w, nf)
            aligned = self.MV_deform_align(
                center_rep, None, ufs_p, mv, warped_feat=warped,
                center=center_l1 if cfg.fused_trunk else None)
        return aligned.reshape(k, nm1, h, w, nf)

    def forward(self, lrs, mvs0, mvs1, pms, rms, ufs,
                pre_l1: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                gumbel_u: Optional[torch.Tensor] = None):
        self._check_split()
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

        ufs_prior = self.conv_expand_ufs(nbrs(ufs)) if cfg.use_pd else None
        # woMV's alignment never reads the compensated feature (cdfo_tpu's
        # XLA drops its computation likewise)
        fea_i = (self._compensate(nbrs(l1_fea), nbrs(rms), generator,
                                  gumbel_u) if cfg.use_mv else None)
        center_rep = center_fea[:, None].expand(b, n - 1, h, w, cfg.nf) \
            .reshape(b * (n - 1), h, w, cfg.nf)
        aligned = self.MV_deform_align(center_rep, fea_i, ufs_prior,
                                       nbrs(mvs1.to(dt)))
        aligned = aligned.reshape(b, n - 1, h, w, cfg.nf)

        # re-interleave with the center frame in temporal order
        aligned_fea = torch.cat([aligned[:, :center], center_fea[:, None],
                                 aligned[:, center:]], dim=1)
        if self.capture_features:
            self.intermediates["aligned_fea"] = aligned_fea

        # 3+4. fusion, trunk, upsample head, bilinear base
        sr = self._reconstruct(aligned_fea, None, lrs[:, center])
        return sr, l1_fea
