"""Multi-wavelet contrastive perceptual losses (``cdfo_tpu/losses/
wavelet.py``; reference `opt/loss.py:59-241`), on NHWC tensors.

A J=1 Haar DWT (reflect padding: the pytorch_wavelets DWTForward the
reference uses at `:145`) splits SR / HR / bicubic-upsampled LR into high
bands (HH / HL / LH, rescaled x0.5 + 0.5) and the low band; LPIPS distances
form positives against the HR bands and negatives against the LR bands
(each also under ``neg`` batch shuffles), combined as pos / (neg + 3e-7)
(`:231-241`).

``lpips_fn(a, b) -> (B,)`` takes NCHW 3-channel tensors, as the port's
``metrics.lpips.LPIPS`` does; single-channel inputs are tiled to 3
channels. The reference computes the positives and negatives under
``no_grad`` (`:177-181`) and ``cdfo_tpu`` through ``stop_gradient``, so the
contrastive term carries no gradient: the port computes it under
``torch.no_grad`` and ``charbonnier_fcl_loss``'s gradient is the
Charbonnier loss's. A shuffle permutes both sides of a negative pair by the
same index, so each shuffled term equals the unshuffled one up to the
order of the batch mean's sum (``cdfo_tpu`` alike): the draws do not move
the value.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .losses import charbonnier_loss


def haar_dwt(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """J=1 Haar DWT of NHWC ``x`` (an odd extent is first padded by
    reflecting its last-but-one row or column). Returns (LL, LH, HL, HH)
    at half resolution, pytorch_wavelets' orthonormal scaling (/2 per 2x2
    block)."""
    if x.shape[1] % 2 == 1:
        x = torch.cat([x, x[:, -2:-1]], dim=1)
    if x.shape[2] % 2 == 1:
        x = torch.cat([x, x[:, :, -2:-1]], dim=2)
    a = x[:, 0::2, 0::2]
    b = x[:, 0::2, 1::2]
    c = x[:, 1::2, 0::2]
    d = x[:, 1::2, 1::2]
    ll = (a + b + c + d) * 0.5
    lh = (-a - b + c + d) * 0.5   # vertical detail (pywt 'LH' = rows high)
    hl = (-a + b - c + d) * 0.5   # horizontal detail
    hh = (a - b - c + d) * 0.5
    return ll, lh, hl, hh


def wave_decompose(x: torch.Tensor, norm: bool = True):
    """([HH, HL, LH], [LL]) of ``x``; with ``norm`` the high bands x0.5 +
    0.5."""
    ll, lh, hl, hh = haar_dwt(x)
    if norm:
        lh, hl, hh = lh * 0.5 + 0.5, hl * 0.5 + 0.5, hh * 0.5 + 0.5
    return [hh, hl, lh], [ll]


def _nchw3(t: torch.Tensor) -> torch.Tensor:
    t = t.permute(0, 3, 1, 2)
    return t.expand(-1, 3, -1, -1) if t.shape[1] == 1 else t


def multiwave_contrastive_loss(sr, lr_up, hr, lpips_fn: Callable,
                               neg: int = 3,
                               generator: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
    """sr / lr_up / hr: (B, H, W, C) centre frames. ``generator`` (a CPU
    generator; seed 0 if None) draws the shuffled negatives' permutations.
    Returns a detached scalar."""
    generator = generator or torch.Generator().manual_seed(0)
    with torch.no_grad():
        sr_h, sr_l = wave_decompose(sr)
        hr_h, hr_l = wave_decompose(hr)
        lr_h, lr_l = wave_decompose(lr_up)
        sr_h.append(sr)
        hr_h.append(hr)
        lr_h.append(lr_up)
        l_list = hr_l + lr_l

        def mean_lpips(a, b):
            return lpips_fn(_nchw3(a), _nchw3(b)).mean()

        pos1 = sum(mean_lpips(a, b) for a, b in zip(sr_h, hr_h)) / len(hr_h)
        pos2 = sum(mean_lpips(sr_l[0], t) for t in l_list) / len(l_list)
        total = 0.0
        for a, b in zip(sr_h, lr_h):
            total = total + mean_lpips(a, b)
            for _ in range(neg):
                perm = torch.randperm(a.shape[0],
                                      generator=generator).to(a.device)
                total = total + mean_lpips(a[perm], b[perm])
        n = total / ((neg + 1) * len(lr_h))
        return pos1 / (n + 3e-7) + pos2 / (n + 3e-7)


def charbonnier_fcl_loss(sr, hr, lr_up, lpips_fn: Callable,
                         generator: Optional[torch.Generator] = None):
    """Charbonnier (sum) + the multi-wavelet contrastive term
    (`opt/loss.py:59-71`)."""
    return charbonnier_loss(sr, hr) + multiwave_contrastive_loss(
        sr, lr_up, hr, lpips_fn, generator=generator)
