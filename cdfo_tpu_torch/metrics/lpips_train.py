"""LPIPS calibration training and 2AFC / JND scoring
(``cdfo_tpu/metrics/lpips_train.py``; the reference vendors richzhang's
`opt/lpips/trainer.py` and `opt/lpips/loss.py:160-198`):

* :func:`score_2afc` / :func:`score_jnd`: dataset-level scoring
  (`trainer.py:206-279`), numpy over precomputed distances;
* :class:`Dist2LogitLayer` / :func:`bce_ranking_loss`: the ranking head
  that fits the linear calibration (`loss.py:170-197`);
* :class:`LPIPSHeadTrainer`: Adam(beta1=0.5) over the linear heads and the
  ranking net, the trunk frozen, with the reference's post-step clamp of
  the heads to >= 0 (`trainer.py:102-105`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.layers import check_device
from .lpips import LPIPS, seed_parameters


# ---------------------------------------------------------------------------
# dataset-level scoring (`trainer.py:206-279`)
# ---------------------------------------------------------------------------


def score_2afc(d0s: np.ndarray, d1s: np.ndarray,
               judges: np.ndarray) -> Tuple[float, Dict[str, np.ndarray]]:
    """Fraction of triplets where the metric agrees with human 2AFC votes.

    judges in [0, 1]: fraction of humans preferring patch p1.
    """
    d0s, d1s, gts = (np.asarray(a, np.float64).reshape(-1)
                     for a in (d0s, d1s, judges))
    scores = ((d0s < d1s) * (1.0 - gts) + (d1s < d0s) * gts
              + (d1s == d0s) * 0.5)
    return float(scores.mean()), dict(d0s=d0s, d1s=d1s, gts=gts,
                                      scores=scores)


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """PASCAL-VOC average precision (the `lpips.voc_ap` the reference's
    JND scorer calls)."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def score_jnd(ds: np.ndarray, sames: np.ndarray) -> Tuple[float, Dict]:
    """JND mAP: area under the precision-recall curve when thresholding
    distances against human 'same' votes."""
    ds = np.asarray(ds, np.float64).reshape(-1)
    sames = np.asarray(sames, np.float64).reshape(-1)
    order = np.argsort(ds)
    sames_sorted = sames[order]
    tps = np.cumsum(sames_sorted)
    fps = np.cumsum(1 - sames_sorted)
    fns = sames_sorted.sum() - tps
    precs = tps / (tps + fps)
    recs = tps / (tps + fns)
    return voc_ap(recs, precs), dict(ds=ds, sames=sames)


# ---------------------------------------------------------------------------
# ranking head (`loss.py:170-197`)
# ---------------------------------------------------------------------------


class Dist2LogitLayer(nn.Module):
    """(d0, d1) -> probability that p1 is closer: a 1x1 conv MLP (32 mid
    channels, leaky ReLU 0.2, sigmoid) on the 5-channel stack (d0, d1,
    d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)); d0, d1 (B, 1, h, w).
    Parameter names are the reference's (``model.0``, ``model.2``,
    ``model.4``)."""

    def __init__(self, chn_mid: int = 32,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        check_device(device, "Dist2LogitLayer")
        self.model = nn.Sequential(
            nn.Conv2d(5, chn_mid, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(chn_mid, chn_mid, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(chn_mid, 1, 1), nn.Sigmoid())
        seed_parameters(self, generator or torch.Generator().manual_seed(0))
        self.to(device)

    def forward(self, d0, d1, eps: float = 0.1):
        return self.model(torch.cat(
            [d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)], dim=1))


def bce_ranking_loss(logit, judge, eps: float = 1e-7):
    """BCE of the ranking probability vs the human vote in [-1, 1]
    (`loss.py:194-197` maps judge -> (judge+1)/2)."""
    per = (judge + 1.0) / 2.0
    logit = logit.clamp(eps, 1.0 - eps)
    return -(per * logit.log() + (1 - per) * (1 - logit).log()).mean()


# ---------------------------------------------------------------------------
# head trainer
# ---------------------------------------------------------------------------


class LPIPSHeadTrainer:
    """Fits ``model``'s linear heads on 2AFC triplets, its trunk frozen, on
    the model's device.

    Reference recipe: Adam(lr=1e-4, betas=(0.5, 0.999)) over the heads and
    the ranking net (`trainer.py:75-80`), the heads clamped to >= 0 after
    each step (`trainer.py:102-105`). ``rank``: the ranking net (a
    ``Dist2LogitLayer`` seeded ``seed`` on the model's device if None).
    """

    def __init__(self, model: LPIPS, lr: float = 1e-4, beta1: float = 0.5,
                 seed: int = 0, rank: Optional[Dist2LogitLayer] = None):
        self.model = model
        self.device = next(model.parameters()).device
        model.net.requires_grad_(False)
        self.rank = rank or Dist2LogitLayer(
            generator=torch.Generator().manual_seed(seed), device=self.device)
        self.heads = [lin.model[1].weight for lin in model.lins()]
        self.optimizer = torch.optim.Adam(
            self.heads + list(self.rank.parameters()), lr=lr,
            betas=(beta1, 0.999), eps=1e-8)

    def train_step(self, ref, p0, p1, judge) -> float:
        """One Adam step on the triplets ``ref``, ``p0``, ``p1`` (B, 3, H,
        W) and the votes ``judge`` (B,) in [-1, 1]; returns the loss."""
        ref, p0, p1, judge = (torch.as_tensor(t, dtype=torch.float32)
                              .to(self.device) for t in (ref, p0, p1, judge))
        d0 = self.model(ref, p0).reshape(-1, 1, 1, 1)
        d1 = self.model(ref, p1).reshape(-1, 1, 1, 1)
        loss = bce_ranking_loss(self.rank(d0, d1), judge.reshape(-1, 1, 1, 1))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        with torch.no_grad():
            for w in self.heads:
                w.clamp_(min=0.0)
        return loss.item()
