"""Training losses (``cdfo_tpu/losses/losses.py``; the reference's
``opt/loss.py``), on NHWC tensors.

The trainer's loss is Charbonnier with **sum** reduction and eps=1e-4
added *inside* the sqrt (`opt/loss.py:20-31`, used `train_LD_37.py:377`).
The multi-wavelet contrastive loss is ``losses/wavelet.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# the four Sobel directions as (out, in, kh, kw) cross-correlation taps
_SOBEL = torch.tensor([
    [[1, 2, 1], [0, 0, 0], [-1, -2, -1]],
    [[1, 0, -1], [2, 0, -2], [1, 0, -1]],
    [[2, 1, 0], [1, 0, -1], [0, -1, -2]],
    [[0, 1, 2], [-1, 0, 1], [-2, -1, 0]],
], dtype=torch.float32)[:, None]


def charbonnier_loss(x: torch.Tensor, y: torch.Tensor,
                     eps: float = 1e-4) -> torch.Tensor:
    """sum(sqrt((x - y)^2 + eps)); eps is not squared (`opt/loss.py:24`)."""
    diff = x - y
    return torch.sqrt(diff * diff + eps).sum()


def charbonnier_loss_masked(x, y, mask, eps: float = 1e-4):
    """CharbonnierLoss_g (`opt/loss.py:245-254`): masked charbonnier."""
    diff = (x - y) * mask
    return torch.sqrt(diff * diff + eps).sum()


def mse_loss(x, y):
    return (x - y).square().mean()


def total_variation(x, reduction: str = "sum"):
    """Anisotropic TV (`opt/loss.py:7-17`): x is (..., H, W)."""
    hor = x[..., :-1, :] - x[..., 1:, :]
    ver = x[..., :-1] - x[..., 1:]
    return hor.abs().sum() + ver.abs().sum()


def sobel_loss(x, y, eps: float = 1e-4):
    """4-direction Sobel edge charbonnier (`opt/loss.py:257-281`); x, y
    (B, H, W, C), each channel filtered alone, zero padded."""
    def edges(t):
        b, h, w, c = t.shape
        planes = t.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
        return F.conv2d(planes, _SOBEL.to(t.device, t.dtype), padding=1)

    diff = edges(x) - edges(y)
    return torch.sqrt(diff * diff + eps).sum()


def charbonnier_etc_loss(x, y, eps: float = 1e-4):
    """Charbonnier + 0.1x temporal FFT-energy consistency
    (`opt/loss.py:34-56`); x, y (B, N, H, W, C) frame sequences."""
    diff = x - y
    loss_spa = torch.sqrt(diff * diff + eps).sum()
    xe = torch.fft.rfft2(x, dim=(2, 3)).real
    ye = torch.fft.rfft2(y, dim=(2, 3)).real
    sr_e = 0.0
    gt_e = 0.0
    for i in range(x.shape[1] - 1):
        # the reference's accumulation, including its reuse of the GT
        # accumulator on the SR side (`opt/loss.py:50-51`)
        sr_e = gt_e + (xe[:, i + 1].abs() - xe[:, i].abs())
        gt_e = gt_e + (ye[:, i + 1].abs() - ye[:, i].abs())
    loss_energy = torch.as_tensor(gt_e).sum() - torch.as_tensor(sr_e).sum()
    return loss_spa + 0.1 * loss_energy
