"""Image-quality metrics (numpy copies of ``cdfo_tpu.metrics``' full-reference
metrics and MATLAB helpers)."""
from .psnr_ssim import (
    bgr2ycbcr,
    cal_psnr_ssim,
    cal_psnr_ssim_tof,
    cal_psnr_ssim_tof_cvcp,
    cal_psnr_ssim_tof_reds,
    cal_psnr_ssim_tof_vid4,
    calculate_psnr,
    calculate_ssim,
    calculate_tof,
    rgb2ycbcr,
    to_y_channel,
    ycbcr2bgr,
    ycbcr2rgb,
)

__all__ = [
    "calculate_psnr", "calculate_ssim", "calculate_tof", "cal_psnr_ssim",
    "cal_psnr_ssim_tof", "cal_psnr_ssim_tof_cvcp", "cal_psnr_ssim_tof_reds",
    "cal_psnr_ssim_tof_vid4", "rgb2ycbcr", "bgr2ycbcr", "ycbcr2rgb",
    "ycbcr2bgr", "to_y_channel",
]
