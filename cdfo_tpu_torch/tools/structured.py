"""The small trained CVSR_V8 that ``int8_delta`` and ``gumbel_variance``
measure (the harness the repository's ``tools/gumbel_variance.py`` and
``tools/int8_delta.py`` share): smooth moving random fields as video
(HR at 4x, LR = MATLAB bicubic / 4), 7-frame windows of 32x32 LR frames
with zero motion vectors and priors made from the LR itself, a model
trained by Adam (3e-4) on the Charbonnier mean of one window's centre
frame a step, and the mean PSNR (crop 4) over every window of two held-out
sequences.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..metrics.matlab import imresize
from ..metrics.psnr_ssim import calculate_psnr
from ..models import CVSRV8

N, T, H, W = 7, 9, 32, 32   # window, frames per sequence, LR height, width


def make_structured_videos(n_seq, t, h, w, seed=0):
    """Smooth moving random fields; HR (n,t,4h,4w), LR = MATLAB bicubic /4."""
    r = np.random.RandomState(seed)
    hrs = np.empty((n_seq, t, 4 * h, 4 * w), np.float32)
    lrs = np.empty((n_seq, t, h, w), np.float32)
    yy, xx = np.mgrid[0:4 * h, 0:4 * w].astype(np.float64)
    for s in range(n_seq):
        phases = r.rand(6, 4) * [0.2, 0.2, 6.28, 1.0]
        dx, dy = r.randn(2) * 1.5
        for ti in range(t):
            img = np.zeros((4 * h, 4 * w))
            for fy, fx, ph, amp in phases:
                img += amp * np.sin(fy * (yy + dy * ti * 4)
                                    + fx * (xx + dx * ti * 4) + ph)
            img = (img - img.min()) / (np.ptp(img) + 1e-9)
            hrs[s, ti] = img
            lrs[s, ti] = imresize(img, 0.25, antialiasing=True)
    return lrs, hrs


def window(lrs_arr, s, f0):
    """Sequence s's frames f0 .. f0 + 6 as a (1, 7, H, W, 1) batch."""
    return lrs_arr[s, f0:f0 + N][..., None][None].astype(np.float32)


def priors(lrs_win):
    """(pms, rms, ufs) of a window: non-degenerate priors, so that the EGLA
    residual-mask branch is exercised (residual = the LR's high-frequency
    detail, prediction = the LR itself)."""
    blur = lrs_win.copy()
    blur[..., 1:-1, :, 0] = (lrs_win[..., :-2, :, 0]
                             + lrs_win[..., 2:, :, 0]) / 2
    rmsw = np.abs(lrs_win - blur)
    return lrs_win, rmsw, lrs_win


def _inputs(win, device):
    """The model's six inputs for a window, on ``device`` (zero MVs)."""
    zmv = torch.zeros((1, N) + win.shape[2:4] + (2,), device=device)
    pms, rms, ufs = (torch.from_numpy(a).to(device) for a in priors(win))
    return torch.from_numpy(win).to(device), zmv, zmv, pms, rms, ufs


def train(cfg, steps: int, device, generator: Optional[torch.Generator] = None,
          log: Callable = print, seed: int = 0) -> CVSRV8:
    """A CVSR_V8 of ``cfg`` from weights drawn with ``seed``, trained
    ``steps`` steps on six structured sequences (batch 1, a random window a
    step) on ``device``; under ``mask_mode="sample"`` the gumbel noise
    comes from ``generator``."""
    lr_tr, hr_tr = make_structured_videos(6, T, H, W, seed=0)
    model = CVSRV8(cfg, torch.Generator().manual_seed(seed), device=device)
    opt = torch.optim.Adam(model.parameters(), lr=3e-4)
    r = np.random.RandomState(0)
    t0 = time.time()
    loss = torch.zeros(())
    for _ in range(steps):
        s = r.randint(0, lr_tr.shape[0])
        f0 = r.randint(0, T - N + 1)
        hr = torch.from_numpy(hr_tr[s, f0 + N // 2][None, ..., None]).to(
            device)
        sr, _ = model(*_inputs(window(lr_tr, s, f0), device),
                      generator=generator)
        loss = torch.mean(torch.sqrt((sr - hr) ** 2 + 1e-6))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    log(f"trained {steps} steps in {time.time() - t0:.0f}s "
        f"(final loss {loss.item():.3f})")
    return model


def eval_model(trained: CVSRV8, **cfg_kw) -> CVSRV8:
    """A CVSR_V8 of ``trained``'s config with ``cfg_kw`` changed, on its
    device, holding its weights."""
    model = CVSRV8(dataclasses.replace(trained.cfg, **cfg_kw),
                   torch.Generator().manual_seed(0),
                   device=next(trained.parameters()).device)
    model.load_state_dict(trained.state_dict())
    return model


@torch.inference_mode()
def eval_psnr(model: CVSRV8, generator: Optional[torch.Generator] = None,
              ) -> float:
    """Mean PSNR (crop 4, [0, 255]) of the centre frames of every window of
    two held-out structured sequences; the sampled mask's noise drawn from
    ``generator``, window by window."""
    lr_ev, hr_ev = make_structured_videos(2, T, H, W, seed=99)
    device = next(model.parameters()).device
    psnrs = []
    for s in range(lr_ev.shape[0]):
        for f0 in range(0, T - N + 1):
            sr, _ = model(*_inputs(window(lr_ev, s, f0), device),
                          generator=generator)
            img = np.clip(sr[0, :, :, 0].float().cpu().numpy(), 0, 1) * 255
            gt = hr_ev[s, f0 + N // 2] * 255
            psnrs.append(calculate_psnr(img, gt, crop_border=4))
    return float(np.mean(psnrs))
